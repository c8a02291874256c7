"""Port parity, the slice as a whole: ``cmfem_tpu_torch.entry`` against the
same implicit BE step of 3D CDR built with the JAX package (its
``__graft_entry__.entry()`` recipe, in float64 and at n=4).

GMRES(30) steps match to 1e-9 relative in x with equal iteration counts;
entry()'s CG variant stagnates identically in both (parity only: CG is not
a solver for this nonsymmetric operator)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import cmfem_tpu_torch
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_3d as j_mesh3d
from cmfem_tpu.ops import BilinearForm as JForm, SpaceOps as JSpaceOps
from cmfem_tpu.ops.partial import StructuredGrid3D as JGrid
from cmfem_tpu.ops.sumfact import SumFactoredOperator as JSumFact
from cmfem_tpu.solvers import (
    cg as j_cg,
    gmres as j_gmres,
    jacobi_preconditioner as j_jacobi,
)

from cmfem_tpu_torch.entry import BETA, DT, entry, spd_step

N, ORDER = 4, 2


def _jax_step(spd=False, solver="gmres"):
    """__graft_entry__.entry()'s construction in float64 with a choice of
    solver; returns x after one step from the same u0."""
    mesh = j_mesh3d(N, N, N)
    fes = JFESpace(mesh, ORDER)
    ops = JSpaceOps(fes, quad_order=2 * ORDER)
    lhs = JForm(ops).add_mass(1.0)
    if not spd:
        lhs = lhs.add_convection(BETA, alpha=DT)
    lhs = lhs.add_diffusion(0.1 * DT)
    ldata = lhs.assemble()
    op = JSumFact(ops, ldata, N, N, N, ORDER, dtype=jnp.float64)
    fn, D = op.bind()
    grid = JGrid(N, N, N, ORDER)
    mask = jnp.asarray(grid.boundary_mask())
    diag_ent = lhs.assemble_diagonal(ldata)
    pos = np.round(np.asarray(fes.node_positions) * (grid.NX - 1)).astype(int)
    lat = (pos[:, 2] * grid.NY + pos[:, 1]) * grid.NX + pos[:, 0]
    diag = jnp.zeros(grid.ndofs).at[jnp.asarray(lat)].set(diag_ent)
    M = j_jacobi(jnp.where(mask, 1.0, diag))
    apply_A = lambda v: jnp.where(mask, v, fn(jnp.where(mask, 0.0, v), D))
    u0 = jnp.zeros(grid.ndofs).at[grid.ndofs // 2].set(1.0)
    B = jnp.where(mask, 0.0, u0)
    if solver == "gmres":
        return j_gmres(apply_A, B, x0=u0, M=M, rtol=1e-6, restart=30)
    return j_cg(apply_A, B, x0=u0, M=M, rtol=1e-6, maxiter=100)


def _rel(x, jx):
    jx = np.asarray(jx)
    return np.linalg.norm(x.cpu().numpy() - jx) / np.linalg.norm(jx)


def test_gmres_step_matches_jax():
    step, (u0, D) = entry(n=N, order=ORDER, device="cpu", dtype=torch.float64)
    assert step.path == "plain-chain" and step.solver == "gmres"
    assert step.op.compressed and step.op.z_periodic
    res = step(u0, D)
    jres = _jax_step()
    assert res.converged and bool(jres.converged)
    assert (res.iters, res.inner_iters) == (int(jres.iters),
                                            int(jres.inner_iters))
    assert _rel(res.x, jres.x) <= 1e-9
    # the same step through the z-periodic plain chain (the kernel's plain
    # version) agrees as well
    fnp, Dp = step.op.bind(use_periodic=True)
    assert _rel(step.solve(u0, fnp, Dp).x, jres.x) <= 1e-9


def test_cg_step_stagnates_like_jax():
    step, (u0, D) = entry(n=N, order=ORDER, device="cpu", dtype=torch.float64,
                          solver="cg")
    res = step(u0, D)
    jres = _jax_step(solver="cg")
    assert not res.converged and res.stagnated and bool(jres.stagnated)
    assert res.iters == int(jres.iters)
    assert _rel(res.x, jres.x) <= 1e-9


def test_spd_step_matches_jax():
    step, (u0, D) = spd_step(n=N, order=ORDER, device="cpu",
                             dtype=torch.float64)
    res = step(u0, D)
    jres = _jax_step(spd=True, solver="cg")
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert _rel(res.x, jres.x) <= 1e-9


def test_float32_step_converges_near_float64():
    step, (u0, D) = entry(n=N, order=ORDER, device="cpu", dtype=torch.float32)
    assert step.op.D.dtype == torch.float32
    res = step(u0, D)
    assert res.converged and res.rel_residual <= 2e-6
    assert _rel(res.x, _jax_step().x) <= 1e-4


def test_default_device_is_the_gpu():
    """entry() without a device never falls back to the CPU."""
    if torch.cuda.is_available():
        assert cmfem_tpu_torch.require_cuda().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cmfem_tpu_torch.require_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spd_step(n=2)


def test_bad_solver_name_is_refused():
    with pytest.raises(ValueError, match="solver"):
        entry(n=2, order=1, device="cpu", solver="bicgstab")


@pytest.mark.gpu
def test_cuda_step_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.kernels import sumfact as ksum

    step, (u0, D) = entry(n=6, order=ORDER, dtype=torch.float64)
    assert step.path == "cuda-sumfact-zperiodic"
    before = ksum.launches
    res = step(u0, D)
    assert ksum.launches > before and res.converged
    ref_step, (ru0, rD) = entry(n=6, order=ORDER, device="cpu",
                                dtype=torch.float64)
    assert _rel(res.x, ref_step(ru0, rD).x.numpy()) <= 1e-9
