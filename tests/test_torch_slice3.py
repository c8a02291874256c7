"""Port parity, slice 3: ``entry.operator_paths`` (the operator-apply paths
of ``bench.py::bench_operator``) and the BE steps through the z-chain, on
the CPU in float64.

- ``operator_paths(n=3, order)`` at orders 2 and 4: the eight paths, named
  as in the port's table, each agree with JAX's ``bind()`` on the same
  form (diffusion 0.1 + convection + mass) to 1e-12 max|y|;
- ``entry(n=4, order=3)``: the step through
  ``bind_zchain(use_periodic=True)`` equals the step through ``bind()``
  (x to 1e-10 relative, the same iteration counts); ``vc_entry(n=3,
  order=4)`` likewise through ``bind_zchain()`` on full D."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_3d as j_mesh3d
from cmfem_tpu.ops import BilinearForm as JForm, SpaceOps as JSpaceOps
from cmfem_tpu.ops.sumfact import SumFactoredOperator as JSumFact

from cmfem_tpu_torch.entry import PATHS, entry, operator_paths, vc_entry
from cmfem_tpu_torch.kernels import zchain as kz

BETA = np.array([1.0, -2.0, 0.5])


@pytest.mark.parametrize("order", [2, 4])
def test_operator_paths_match_jax_bind(order):
    n = 3
    jops = JSpaceOps(JFESpace(j_mesh3d(n, n, n), order),
                     quad_order=2 * order)
    jdata = (JForm(jops).add_diffusion(0.1).add_convection(BETA)
             .add_mass(1.0).assemble())
    jop = JSumFact(jops, jdata, n, n, n, order, dtype=jnp.float64)
    P = operator_paths(n=n, order=order, device="cpu", dtype=torch.float64)
    assert tuple(P.paths) == PATHS  # uniform D: the periodic paths too
    assert P.ndofs == jop.ndofs == (n * order + 1) ** 3
    assert P.sumfact.z_periodic and P.lat.shape == (P.ndofs,)
    assert sorted(P.lat.tolist()) == list(range(P.ndofs))
    u = np.random.default_rng(order).standard_normal(P.ndofs)
    jfn, jD = jop.bind()
    y_ref = np.asarray(jfn(jnp.asarray(u), jD))
    scale = np.abs(y_ref).max()
    before = kz.launches
    for name, (fn, arrays) in P.paths.items():
        y = fn(torch.as_tensor(u), *arrays)
        assert y.shape == (P.ndofs,), name
        np.testing.assert_allclose(y.numpy() / scale, y_ref / scale,
                                   atol=1e-12, err_msg=name)
    assert kz.launches == before  # the CPU runs the plain versions


def _same_step(step, u0, D, fz, Dz):
    res = step(u0, D)
    ref = step.solve(u0, *step.op.bind())
    rz = step.solve(u0, fz, Dz)
    for r in (res, rz):
        assert r.converged
        assert (r.iters, r.inner_iters) == (ref.iters, ref.inner_iters)
        rel = float(torch.linalg.vector_norm(r.x - ref.x)
                    / torch.linalg.vector_norm(ref.x))
        assert rel <= 1e-10, rel


def test_entry_order3_step_through_zchain_matches_bind():
    step, (u0, D) = entry(n=4, order=3, device="cpu", dtype=torch.float64)
    assert step.path == "plain-chain" and step.op.z_periodic
    _same_step(step, u0, D, *step.op.bind_zchain(use_periodic=True))


def test_vc_entry_order4_step_through_zchain_matches_bind():
    step, (u0, D) = vc_entry(n=3, order=4, device="cpu",
                             dtype=torch.float64)
    assert not step.op.z_periodic
    _same_step(step, u0, D, *step.op.bind_zchain())
