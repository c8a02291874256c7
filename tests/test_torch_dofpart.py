"""Port parity, ``parallel/dofpart.py``: ``DofPartition``'s maps equal to the
JAX package's as integers, the per-rank memory (weak scaling at 2, 4 and 8
ranks), the refusals, and on gloo worlds of 2 and 4 CPU ranks the three
halo functions against JAX's under ``shard_map`` on as many virtual
devices, ``DofPartitionedOperator``'s apply (1e-11) and its Jacobi-CG (the
JAX iteration count, x to 1e-10), float64 on the 6^3 order-2 mesh of
``tests/test_dofpart.py``.  One spawn per world size."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_helpers as H
from cmfem_tpu_torch.core import make_cartesian_mesh_3d
from cmfem_tpu_torch.parallel import spawn_ranks
from cmfem_tpu_torch.parallel.dofpart import DofPartition

MAPS = ("owner", "parts", "nown", "eldofs_loc_np", "pub_src_np", "pub_dst_np",
        "pub_src_rev_np", "ghost_src_np")


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, spawn_ranks(H.dofpart_checks, n, (n,), timeout=180)


@pytest.fixture(scope="module")
def jax_problem():
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d as jmesh
    from cmfem_tpu.ops import BilinearForm, SpaceOps

    fes = FESpace(jmesh(6, 6, 6), 2)
    ops = SpaceOps(fes, quad_order=4)
    cdr = (BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
           .add_convection(H.BETA))
    spd = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    return fes, ops, cdr, spd


@pytest.mark.parametrize("ndev", [2, 4, 8, 3])
def test_dof_partition_maps_equal_jax(jax_problem, ndev):
    from cmfem_tpu.parallel.dofpart import DofPartition as JDP

    fes = jax_problem[0]
    jdp = JDP(fes.element_dofs, fes.nscalar, ndev, mesh=fes.mesh)
    mesh = make_cartesian_mesh_3d(6, 6, 6)
    dp = DofPartition(fes.element_dofs, fes.nscalar, ndev, mesh=mesh)
    for name in ("n_interface", "nown_max", "nghost_max", "n_loc", "ne_max"):
        assert getattr(dp, name) == getattr(jdp, name), name
    for name in MAPS:
        a, b = getattr(dp, name), getattr(jdp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for d in range(ndev):
        for name in ("owned", "ghosts", "elem_idx", "loc_maps"):
            np.testing.assert_array_equal(getattr(dp, name)[d],
                                          getattr(jdp, name)[d])
    w = np.random.default_rng(ndev).standard_normal((fes.mesh.num_elements,
                                                     3))
    for fill in ("zero", "dup"):
        np.testing.assert_array_equal(dp.pack_elem(w, fill),
                                      jdp.pack_elem(w, fill))
    x = np.random.default_rng(0).standard_normal(fes.nscalar)
    slabs = np.stack([dp.to_dist(x, r) for r in range(ndev)])
    np.testing.assert_array_equal(dp.from_dist(slabs), x)


def test_dofpart_memory_weak_scaling(jax_problem):
    """Per-rank floats shrink with the rank count as the JAX package's do:
    the owned slab ~ nglobal / N, the ghosts a surface term."""
    from cmfem_tpu.parallel import DofPartitionedOperator as JOp
    from cmfem_tpu.parallel import make_device_mesh as jmdm

    fes, ops, cdr, _ = jax_problem
    data = cdr.assemble()
    mesh = make_cartesian_mesh_3d(6, 6, 6)
    floats = {}
    for ndev in (2, 4, 8):
        dp = DofPartition(fes.element_dofs, fes.nscalar, ndev, mesh=mesh)
        floats[ndev] = dp.nown_max + dp.nghost_max
        assert floats[ndev] == JOp(ops, data, jmdm(ndev)).per_device_floats()
        assert dp.nown_max <= fes.nscalar // ndev + dp.n_interface
    assert floats[2] > floats[4] > floats[8]
    assert floats[4] < 0.75 * floats[2]
    assert floats[8] < 0.75 * floats[4]


def test_dof_partition_refusals():
    mesh = make_cartesian_mesh_3d(2, 2, 2)
    ed = np.arange(8 * 8).reshape(8, 8) % 27
    parts = np.zeros(8, dtype=np.int64)
    parts[0] = 7  # computed for another rank count
    with pytest.raises(ValueError, match="parts ids"):
        DofPartition(ed, 27, 4, parts=parts)
    with pytest.raises(ValueError, match="entries for"):
        DofPartition(ed, 27, 4, parts=np.zeros(5, dtype=np.int64))
    with pytest.raises(ValueError, match="touched by no element"):
        DofPartition(ed, 30, 2, mesh=mesh)


def _jax_halos(fes, ndev, u, v_loc):
    """The JAX package's halo_forward / reverse / assemble under shard_map
    on ``ndev`` virtual devices: (ndev, n_loc), (ndev, nown_max), (ndev,
    n_loc)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cmfem_tpu.parallel import make_device_mesh
    from cmfem_tpu.parallel.dofpart import DofPartition as JDP
    from cmfem_tpu.parallel.dofpart import (halo_assemble, halo_forward,
                                            halo_reverse)

    jm = make_device_mesh(ndev)
    dp = JDP(fes.element_dofs, fes.nscalar, ndev, mesh=fes.mesh)
    sh = NamedSharding(jm, P("dd"))
    put = lambda a: jax.device_put(np.asarray(a).reshape(-1), sh)
    maps = [put(getattr(dp, k)) for k in ("pub_src_np", "pub_dst_np",
                                          "pub_src_rev_np", "ghost_src_np")]
    nif, ng, no = dp.n_interface, dp.nghost_max, dp.nown_max
    spec = (P("dd"),) * 5

    @partial(jax.shard_map, mesh=jm, in_specs=spec, out_specs=P("dd"))
    def fwd(x, ps, pd, pr, gs):
        return halo_forward(x, ps, pd, gs, nif, ng, "dd")

    @partial(jax.shard_map, mesh=jm, in_specs=spec, out_specs=P("dd"))
    def rev(v, ps, pd, pr, gs):
        return halo_reverse(v, pr, pd, gs, nif, no, "dd")

    @partial(jax.shard_map, mesh=jm, in_specs=spec, out_specs=P("dd"))
    def asm(v, ps, pd, pr, gs):
        return halo_assemble(v, ps, pd, pr, gs, nif, no, "dd")

    x = np.stack([np.pad(u[o], (0, no - len(o))) for o in dp.owned])
    return (np.asarray(fwd(put(x), *maps)).reshape(ndev, -1),
            np.asarray(rev(put(v_loc), *maps)).reshape(ndev, -1),
            np.asarray(asm(put(v_loc), *maps)).reshape(ndev, -1))


def test_halo_functions_match_jax(world, jax_problem):
    n, ranks = world
    fes = jax_problem[0]
    u = np.random.default_rng(3).standard_normal(fes.nscalar)
    dp = DofPartition(fes.element_dofs, fes.nscalar, n,
                      mesh=make_cartesian_mesh_3d(6, 6, 6))
    v_loc = np.random.default_rng(8).standard_normal((n, dp.n_loc))
    jf, jr, ja = _jax_halos(fes, n, u, v_loc)
    for rec in ranks:
        r = rec["rank"]
        np.testing.assert_array_equal(rec["fwd"], jf[r])
        # real slots: the owned values, then the ghosts' global values
        k = len(dp.ghosts[r])
        np.testing.assert_array_equal(
            rec["fwd"][:dp.nown_max + k],
            np.concatenate([dp.to_dist(u, r), u[dp.ghosts[r]]]))
        np.testing.assert_allclose(rec["rev"], jr[r], rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(rec["asm"], ja[r], rtol=1e-13, atol=1e-13)


def test_dofpart_apply_matches_jax(world, jax_problem):
    from cmfem_tpu.ops.partial import PAOperator
    from cmfem_tpu.parallel import DofPartitionedOperator as JOp
    from cmfem_tpu.parallel import make_device_mesh as jmdm

    n, ranks = world
    fes, ops, cdr, _ = jax_problem
    data = cdr.assemble()
    u = np.random.default_rng(3).standard_normal(fes.nscalar)
    fn, Dflat, eldofs = PAOperator(ops, data, dtype=jnp.float64).bind()
    y_ref = np.asarray(fn(jnp.asarray(u), Dflat, eldofs))
    jop = JOp(ops, data, jmdm(n))
    y_jax = jop.from_dist(jop(jop.to_dist(u)))
    scale = np.abs(y_ref).max()
    for rec in ranks:
        assert np.abs(rec["y"] - y_jax).max() / scale < 1e-11
        assert np.abs(rec["y"] - y_ref).max() / scale < 1e-11
        np.testing.assert_array_equal(rec["roundtrip"], u)
        assert rec["per_device_floats"] == jop.per_device_floats()


def test_dofpart_cg_matches_jax(world, jax_problem):
    from cmfem_tpu.parallel import DofPartitionedOperator as JOp
    from cmfem_tpu.parallel import make_device_mesh as jmdm
    from cmfem_tpu.solvers import cg

    n, ranks = world
    fes, ops, _, spd = jax_problem
    data = spd.assemble()
    diag = np.asarray(spd.assemble_diagonal(data))
    jop = JOp(ops, data, jmdm(n))
    b = np.random.default_rng(5).standard_normal(fes.nscalar)
    dinv = jop.to_dist(1.0 / diag)
    res = cg(jop, jop.to_dist(b), M=lambda r: dinv * r, rtol=1e-13,
             maxiter=2000)
    assert bool(res.converged)
    x_jax = jop.from_dist(res.x)
    for rec in ranks:
        assert rec["converged"]
        assert rec["iters"] == int(res.iters)
        rel = np.linalg.norm(rec["x"] - x_jax) / np.linalg.norm(x_jax)
        assert rel < 1e-10, rel


@pytest.mark.gpu
def test_cuda_dofpart_one_nccl_rank_and_two_gloo_ranks(tmp_path):
    """On the card: a world of one NCCL rank in this process, and two gloo
    ranks on the one card (NCCL refuses two ranks on one GPU), each against
    the single-device apply and CG."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from cmfem_tpu_torch.parallel import init_rank

    init_rank(0, 1, str(tmp_path / "store"), device="cuda:0")
    try:
        (one,) = [H.dofpart_checks(1, "cuda:0")]
    finally:
        dist.destroy_process_group()
    recs = spawn_ranks(H.dofpart_checks, 2, (2, "cuda"), device="cuda:0",
                       backend="gloo", timeout=240)
    for rec in [one, *recs]:
        assert rec["converged"]
        np.testing.assert_allclose(rec["x"], one["x"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(rec["y"], one["y"], rtol=0,
                                   atol=1e-11 * np.abs(one["y"]).max())
    assert recs[0]["iters"] == recs[1]["iters"] == one["iters"]
