"""Port parity, ``ops/sumfact_sharded.py``: ``ShardedSumFactOperator`` at
orders 1 and 2 on 8^3 hexes, on gloo worlds of 2 and 4 CPU ranks, against
the JAX package's z-sharded operator on as many virtual devices and its
single-device ``SumFactoredOperator`` (1e-12 of max|y|, float64): the
global apply, each slab after the halo sum (the duplicated planes agree
between neighbours), the layout round trip and the ownership weights; and
CG on the slabs with the layout's plain dots (the JAX iteration count, x
to 1e-10 of JAX's sharded solve, 1e-8 of the single-device one).  One
spawn per world size."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist_helpers as H
from cmfem_tpu_torch.parallel import spawn_ranks

N = 8


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, spawn_ranks(H.sumfact_sharded_checks, n, (n,), timeout=180)


def _jax_ops(order, spd=False):
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d
    from cmfem_tpu.ops import BilinearForm, SpaceOps

    fes = FESpace(make_cartesian_mesh_3d(N, N, N), order)
    ops = SpaceOps(fes, quad_order=2 * order)
    form = (BilinearForm(ops).add_diffusion(1.0).add_mass(1.0) if spd else
            BilinearForm(ops).add_diffusion(0.3).add_convection(H.BETA)
            .add_mass(1.0))
    return ops, form.assemble()


@pytest.mark.parametrize("order", [1, 2])
def test_sharded_sumfact_matches_jax(world, order):
    from cmfem_tpu.ops.sumfact import SumFactoredOperator
    from cmfem_tpu.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu.parallel import make_device_mesh

    n, ranks = world
    ops, data = _jax_ops(order)
    ref = SumFactoredOperator(ops, data, N, N, N, order, dtype=jnp.float64)
    sh = ShardedSumFactOperator(ops, data, N, N, N, order,
                                make_device_mesh(n, axis="z"),
                                dtype=jnp.float64)
    u = np.random.default_rng(0).standard_normal(ref.ndofs)
    y_ref = np.asarray(ref(jnp.asarray(u)))
    ys_jax = np.asarray(sh(sh.to_sharded(u)))
    y_jax = sh.from_sharded(ys_jax)
    w_jax = np.asarray(sh.ownership_weights()).reshape(n, -1)
    scale = np.abs(y_ref).max()
    npl = sh.nplanes_loc
    for rec in ranks:
        r, got = rec["rank"], rec[order]
        np.testing.assert_allclose(got["y"] / scale, y_ref / scale,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["y"] / scale, y_jax / scale,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            got["slab"] / scale, ys_jax[r * npl:(r + 1) * npl] / scale,
            rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got["roundtrip"], u)
        np.testing.assert_array_equal(got["weights"].reshape(-1), w_jax[r])
    # the duplicated planes agree between neighbours after the halo sum
    for a, b in zip(ranks, ranks[1:]):
        np.testing.assert_allclose(a[order]["slab"][-1], b[order]["slab"][0],
                                   rtol=0, atol=1e-12 * scale)


def test_sharded_sumfact_cg_matches_jax(world):
    from cmfem_tpu.ops.sumfact import SumFactoredOperator
    from cmfem_tpu.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu.parallel import make_device_mesh
    from cmfem_tpu.solvers import cg

    n, ranks = world
    ops, data = _jax_ops(1, spd=True)
    sh = ShardedSumFactOperator(ops, data, N, N, N, 1,
                                make_device_mesh(n, axis="z"),
                                dtype=jnp.float64)
    ref = SumFactoredOperator(ops, data, N, N, N, 1, dtype=jnp.float64)
    b = np.random.default_rng(1).standard_normal(ref.ndofs)
    r_sh = cg(lambda v: sh(v), sh.to_sharded(b), rtol=1e-12, maxiter=500)
    r_ref = cg(lambda v: ref(v), jnp.asarray(b), rtol=1e-12, maxiter=500)
    x_sh = sh.from_sharded(r_sh.x)
    for rec in ranks:
        assert rec["cg"]["iters"] == int(r_sh.iters)
        np.testing.assert_allclose(rec["cg"]["x"], x_sh, rtol=0, atol=1e-10)
        np.testing.assert_allclose(rec["cg"]["x"], np.asarray(r_ref.x),
                                   rtol=1e-8, atol=1e-10)


def test_sharded_sumfact_refuses_uneven_z():
    """nz must divide by the world size (one rank, no spawn)."""
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
    from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
    from cmfem_tpu_torch.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu_torch.parallel import DeviceMesh

    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(2, 2, 3), 1), quad_order=2,
                   device="cpu")
    data = BilinearForm(ops).add_mass(1.0).assemble()
    mesh = DeviceMesh(0, 2, torch.device("cpu"), None, "z")
    with pytest.raises(ValueError, match="must divide"):
        ShardedSumFactOperator(ops, data, 2, 2, 3, 1, mesh)
    one = ShardedSumFactOperator(ops, data, 2, 2, 3, 1,
                                 DeviceMesh(0, 1, torch.device("cpu"), None,
                                            "z"), dtype=torch.float64)
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(one.ndofs))
    fn, D = one.base.bind()
    torch.testing.assert_close(one(one.to_sharded(u)).reshape(-1), fn(u, D),
                               rtol=1e-13, atol=1e-13)
    assert torch.equal(one.ownership_weights(),
                       torch.ones((one.nplanes_loc, 1, 1),
                                  dtype=torch.float64))
