"""Port parity, solvers: cmfem_tpu_torch.solvers against cmfem_tpu.solvers
on the same numpy-seeded systems, in float64.

Both get the same matrix and right-hand side; the iteration counts, the
flags and x (to 1e-9 relative) must agree.  That includes CG's stagnation
on the nonsymmetric CDR step (Jacobi-CG cannot solve it; GMRES can)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.solvers import (
    cg as j_cg,
    chebyshev_preconditioner as j_cheb,
    gmres as j_gmres,
    jacobi_preconditioner as j_jacobi,
)

from cmfem_tpu_torch.entry import entry
from cmfem_tpu_torch.solvers import (
    cg,
    chebyshev_preconditioner,
    gmres,
    jacobi_preconditioner,
    power_iteration_lmax,
)


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(1.0, cond, n)
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T) + np.diag(rng.uniform(0.0, 5.0, n))
    return A, rng.standard_normal(n)


def _nonsym(n, seed):
    rng = np.random.default_rng(seed)
    A = np.diag(rng.uniform(1.0, 10.0, n)) + rng.standard_normal((n, n)) / 3
    return A, rng.standard_normal(n)


def _both(A, b, x0=None, diag=None):
    """(torch operator, rhs, x0, M) and the same for JAX."""
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    t = (lambda v: At @ v, torch.as_tensor(b),
         None if x0 is None else torch.as_tensor(x0),
         None if diag is None else jacobi_preconditioner(torch.tensor(diag)))
    j = (lambda v: Aj @ v, jnp.asarray(b),
         None if x0 is None else jnp.asarray(x0),
         None if diag is None else j_jacobi(jnp.asarray(diag)))
    return t, j


def _same(res, jres, fields=("iters", "converged", "stagnated")):
    for f in fields:
        jv = getattr(jres, f)
        jv = jv.item() if hasattr(jv, "item") else jv
        assert getattr(res, f) == jv, (f, getattr(res, f), jv)
    xj = np.asarray(jres.x)
    rel = np.linalg.norm(res.x.numpy() - xj) / np.linalg.norm(xj)
    assert rel <= 1e-9, rel
    np.testing.assert_allclose(res.rel_residual, float(jres.rel_residual),
                               rtol=1e-6, atol=1e-11)


@pytest.mark.parametrize("stall_window,precond", [(64, True), (64, False),
                                                  (0, True), (8, True)])
def test_cg_matches_jax(stall_window, precond):
    A, b = _spd(60, 30.0, 0)
    diag = np.diag(A) if precond else None
    (At, bt, _, Mt), (Aj, bj, _, Mj) = _both(A, b, diag=diag)
    kw = dict(rtol=1e-10, maxiter=400, stall_window=stall_window)
    res, jres = cg(At, bt, M=Mt, **kw), j_cg(Aj, bj, M=Mj, **kw)
    assert res.converged
    _same(res, jres)


@pytest.mark.parametrize("restart,x0", [(8, False), (8, True), (60, False)])
def test_gmres_matches_jax(restart, x0):
    A, b = _nonsym(60, 1)
    x0 = np.random.default_rng(9).standard_normal(60) if x0 else None
    (At, bt, xt, Mt), (Aj, bj, xj, Mj) = _both(A, b, x0, diag=np.diag(A))
    kw = dict(rtol=1e-10, restart=restart, maxiter=30)
    res, jres = gmres(At, bt, xt, Mt, **kw), j_gmres(Aj, bj, xj, Mj, **kw)
    assert res.converged
    _same(res, jres, ("iters", "inner_iters", "converged", "stagnated"))


def test_gmres_cycle_cap_and_stagnation_flags_match_jax():
    """A cycle cap hit while still progressing: neither converged nor
    stagnated, in both packages."""
    A, b = _nonsym(60, 2)
    (At, bt, _, _), (Aj, bj, _, _) = _both(A, b)
    kw = dict(rtol=1e-14, restart=3, maxiter=2)
    res, jres = gmres(At, bt, **kw), j_gmres(Aj, bj, **kw)
    assert not res.converged
    _same(res, jres, ("iters", "inner_iters", "converged", "stagnated"))


def test_cg_stagnates_on_cdr_step_like_jax():
    """entry()'s CG variant on the nonsymmetric CDR step: the dense matrix
    of the constrained operator at n=4 goes to both CG solvers."""
    step, (u0, D) = entry(n=4, order=2, device="cpu", dtype=torch.float64,
                          solver="cg")
    apply_A = step.apply_A(step.fn, D)
    n = u0.numel()
    A = torch.stack([apply_A(e) for e in torch.eye(n, dtype=torch.float64)],
                    dim=1).numpy()
    diag = np.where(step.mask.numpy(), 1.0, np.diag(A))
    b = np.where(step.mask.numpy(), 0.0, u0.numpy())
    (At, bt, xt, Mt), (Aj, bj, xj, Mj) = _both(A, b, u0.numpy(), diag)
    res = cg(At, bt, xt, Mt, rtol=1e-6, maxiter=100)
    jres = j_cg(Aj, bj, xj, Mj, rtol=1e-6, maxiter=100)
    assert not res.converged and res.stagnated
    _same(res, jres)
    # the step itself (the operator applied matrix-free) agrees too
    sres = step(u0, D)
    assert (sres.iters, sres.converged, sres.stagnated) == (
        res.iters, res.converged, res.stagnated)
    # GMRES solves the same system
    gres = gmres(At, bt, xt, Mt, rtol=1e-6, restart=30)
    assert gres.converged and gres.rel_residual <= 1e-6


def test_preconditioners_match_jax():
    A, _ = _spd(40, 1e2, 3)
    r = np.random.default_rng(4).standard_normal(40)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    d = np.diag(A).copy()
    np.testing.assert_allclose(
        jacobi_preconditioner(torch.as_tensor(d))(torch.as_tensor(r)).numpy(),
        np.asarray(j_jacobi(jnp.asarray(d))(jnp.asarray(r))), rtol=1e-15)
    lmax = float(np.linalg.eigvalsh(A / np.sqrt(np.outer(d, d))).max())
    for diag in (None, d):
        Mt = chebyshev_preconditioner(lambda v: At @ v, 1.1 * lmax,
                                      degree=5, diag=None if diag is None
                                      else torch.as_tensor(diag))
        Mj = j_cheb(lambda v: Aj @ v, 1.1 * lmax, degree=5,
                    diag=None if diag is None else jnp.asarray(diag))
        np.testing.assert_allclose(Mt(torch.as_tensor(r)).numpy(),
                                   np.asarray(Mj(jnp.asarray(r))),
                                   rtol=1e-12, atol=1e-14)


def test_power_iteration_reaches_lmax():
    A, _ = _spd(30, 50.0, 5)
    At = torch.as_tensor(A)
    lam = power_iteration_lmax(lambda v: At @ v, 30, iters=300,
                               generator=torch.Generator().manual_seed(1),
                               device="cpu")
    ref = np.linalg.eigvalsh(A).max()
    assert abs(float(lam) - ref) <= 1e-6 * ref
