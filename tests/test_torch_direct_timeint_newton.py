"""Port parity: ``solvers/direct.py``, ``solvers/timeint.py`` and
``solvers/newton.py`` against the JAX package on the same numpy-seeded
inputs, float64.

- LU solves agree to 1e-12 (relative to max|x|);
- one ``make_linear_dirk_step`` per tableau on a small finite-element heat
  problem with Jacobi-CG stage solves, with and without ``gdot_stages``:
  the next state to 1e-10 and equal iteration counts;
- ``newton_solve`` on a small nonlinear system with ``dense_solve``: the same
  history (1e-8 relative, 1e-12 absolute: the last residuals are rounding
  noise), ``iterations``, ``converged`` and ``stalled``, each of the three
  stall exits once, the iteration cap, the rebuild frequency and the BC
  re-enforcement."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_2d as j_mesh2d
from cmfem_tpu.ops import BilinearForm as JForm, EssentialBC as JBC
from cmfem_tpu.ops import SpaceOps as JSpaceOps
from cmfem_tpu.solvers import cg as jcg, jacobi_preconditioner as j_jacobi
from cmfem_tpu.solvers import direct as jdirect
from cmfem_tpu.solvers import newton as jnewton
from cmfem_tpu.solvers import timeint as jtimeint

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d
from cmfem_tpu_torch.ops import BilinearForm, EssentialBC, SpaceOps
from cmfem_tpu_torch.solvers import cg, jacobi_preconditioner
from cmfem_tpu_torch.solvers import direct, newton, timeint


# -- direct ------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(5, None), (40, None), (40, 3)])
def test_dense_lu_solves_match(n, k):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n if k is None else (n, k))
    xj = np.asarray(jdirect.dense_solve(A, b))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = direct.dense_solve(At, bt)
    assert x.shape == bt.shape
    tol = 1e-12 * np.abs(xj).max()
    np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=tol)
    fac = direct.dense_factor(At)
    x2 = direct.dense_apply_factor(fac, bt)
    xj2 = np.asarray(jdirect.dense_apply_factor(jdirect.dense_factor(A), b))
    np.testing.assert_allclose(x2.numpy(), xj2, rtol=0, atol=tol)
    np.testing.assert_allclose((At @ x).numpy(), b, rtol=0, atol=1e-12 * n)


# -- timeint -----------------------------------------------------------------

def test_tableaux_and_stage_times_equal():
    for name in ("be", "backward_euler", "sdirk2", "sdirk3", " SDIRK2 "):
        tj, tt = jtimeint.get_tableau(name), timeint.get_tableau(name)
        assert dataclasses.asdict(tj) == dataclasses.asdict(tt)
        assert (tj.stages, tj.gamma, tj.stiffly_accurate) == (
            tt.stages, tt.gamma, tt.stiffly_accurate)
        assert jtimeint.stage_times(tj, 0.3, 0.01) == timeint.stage_times(
            tt, 0.3, 0.01)
    with pytest.raises(ValueError):
        timeint.get_tableau("rk4")


def _heat_pair(tab, dt, geom):
    """M + gamma dt K on a 4 x 4 order-2 mesh, Dirichlet on the whole
    boundary, Jacobi-CG stage solves: (step, n, ness) in both packages."""
    gdt = tab.gamma * dt
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            fes = JFESpace(j_mesh2d(4, 4, geom=geom), 2)
            ops = JSpaceOps(fes)
            Form, kw, where = JForm, {}, jnp.where
            solver, jac, dirk = jcg, j_jacobi, jtimeint.make_linear_dirk_step
        else:
            fes = FESpace(make_cartesian_mesh_2d(4, 4, geom=geom), 2)
            ops = SpaceOps(fes, device="cpu")
            Form, kw, where = BilinearForm, {"device": "cpu"}, torch.where
            solver, jac = cg, jacobi_preconditioner
            dirk = timeint.make_linear_dirk_step
        mass = Form(ops).add_mass(1.0)
        mdata = mass.assemble()
        lhs = Form(ops).add_mass(1.0).add_diffusion(0.7 * gdt)
        ldata = lhs.assemble()
        ess = fes.boundary_dofs()
        bc = (JBC if pkg == "jax" else EssentialBC)(fes.nscalar, ess, **kw)
        M = jac(where(bc.mask, 1.0, lhs.assemble_diagonal(ldata)))
        solve = lambda op, B, x0, M=M, solver=solver: solver(
            op, B, x0=x0, M=M, rtol=1e-12, maxiter=500)
        step = dirk(tab, dt, lambda v, m=mass, d=mdata: m.apply(d, v),
                    lambda v, a=lhs, d=ldata: a.apply(d, v), bc, solve)
        out.append((step, fes.nscalar, len(ess)))
    return out


@pytest.mark.parametrize("name", ["be", "sdirk2", "sdirk3"])
@pytest.mark.parametrize("mode", ["values", "gdot", "homogeneous"])
def test_linear_dirk_step_matches(name, mode):
    dt = 0.02
    tab = timeint.get_tableau(name)
    (jstep, n, ness), (step, n2, ness2) = _heat_pair(
        tab, dt, "quad" if mode != "gdot" else "triangle")
    assert (n, ness) == (n2, ness2)
    rng = np.random.default_rng(len(name))
    u = rng.standard_normal(n)
    f = None if mode == "homogeneous" else rng.standard_normal((tab.stages, n))
    g = rng.standard_normal((tab.stages, ness))
    gdot = rng.standard_normal((tab.stages, ness)) if mode == "gdot" else None
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.as_tensor(a)
    uj, ij = jstep(J(u), J(f), J(g), J(gdot))
    ut, it = step(T(u), T(f), T(g), T(gdot))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-10,
                               atol=1e-10)
    assert int(it) == int(ij) and int(it) > 0


# -- newton ------------------------------------------------------------------

_N = 8


def _system():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((_N, _N)) + 3.0 * _N * np.eye(_N)
    b = 10.0 * rng.standard_normal(_N)
    noise = rng.standard_normal(_N)
    return A, b, noise / np.linalg.norm(noise)


def _problem(pkg, floor=0.0, jitter=0.0):
    """F(x) = A x + x^3 - b; the residual the harness sees carries a fixed
    vector of norm ``floor`` (an evaluation floor), the linear solve uses the
    exact F and J, and adds ``jitter`` to every component of dx."""
    A, b, noise = _system()
    if pkg == "jax":
        A, b, noise = jnp.asarray(A), jnp.asarray(b), jnp.asarray(noise)
        diag, solve = jnp.diag, jdirect.dense_solve
    else:
        A, b, noise = (torch.as_tensor(a) for a in (A, b, noise))
        diag, solve = torch.diag, direct.dense_solve
    F = lambda x: A @ x + x ** 3 - b
    calls = {"rebuild": 0}

    def rebuild(x):
        calls["rebuild"] += 1
        return A + diag(3.0 * x ** 2)

    def solve_linear(x, rhs, jac):
        return solve(jac, -F(x)) + jitter

    return (lambda x: F(x) + floor * noise), solve_linear, rebuild, calls


def _run_both(cfg_kw, floor=0.0, jitter=0.0, enforce=False):
    out = []
    for pkg, mod in (("jax", jnewton), ("torch", newton)):
        residual, solve_linear, rebuild, calls = _problem(pkg, floor, jitter)
        x0 = np.zeros(_N)
        x0 = jnp.asarray(x0) if pkg == "jax" else torch.as_tensor(x0)
        logged = []
        if enforce:
            pin = (lambda x: x.at[0].set(0.25)) if pkg == "jax" else \
                (lambda x: torch.cat([x.new_tensor([0.25]), x[1:]]))
        else:
            pin = None
        x, res = mod.newton_solve(
            residual, x0, solve_linear, mod.NewtonConfig(**cfg_kw),
            enforce_bc=pin, log_iteration=logged.append,
            rebuild_jacobian=rebuild)
        assert logged == res.history
        out.append((np.asarray(x), res, calls["rebuild"]))
    return out


def _same(rj, rt):
    (xj, resj, nj), (xt, rest, nt) = rj, rt
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-8,
                                                    atol=1e-12)
    close(xt, xj)
    assert (rest.converged, rest.stalled, rest.iterations) == (
        resj.converged, resj.stalled, resj.iterations)
    assert nt == nj and len(rest.history) == len(resj.history)
    for ht, hj in zip(rest.history, resj.history):
        assert (ht.iter, ht.converged) == (hj.iter, hj.converged)
        for f in ("residual_norm", "residual_norm0", "relative_residual",
                  "update_norm", "update_norm0", "relative_update"):
            close(getattr(ht, f), getattr(hj, f))
    for f in ("final_residual", "initial_residual", "final_relative_residual",
              "final_update_norm", "initial_update_norm",
              "final_relative_update"):
        close(getattr(rest, f), getattr(resj, f))
    assert rest.timing.solve_sec > 0
    return rest


def test_newton_converges_like_jax():
    res = _same(*_run_both({"abs_tol": 1e-10, "rel_tol": 1e-14}))
    assert res.converged and not res.stalled and 3 <= res.iterations <= 10
    # r0 = max(1, |R0|) and the first record
    assert res.initial_residual == res.history[0].residual_norm0 > 1.0
    assert res.history[-1].converged and res.history[-1].update_norm == 0.0


def test_newton_rebuild_frequency_and_bc_enforcement_match():
    rj, rt = _run_both({"abs_tol": 1e-10, "rel_tol": 1e-14, "max_iter": 40,
                        "jacobian_rebuild_freq": 3}, enforce=True)
    res = _same(rj, rt)
    # the pinned component never moves off its value; the system then has no
    # root, so the run ends at the cap or on a stall, in both the same way
    assert rt[0][0] == 0.25
    assert rt[2] == -(-len([h for h in res.history if not h.converged]) // 3)


def test_newton_iteration_cap_matches():
    res = _same(*_run_both({"abs_tol": 1e-30, "rel_tol": 1e-30, "max_iter": 2,
                            "stall_accept_rel": 0.0}))
    assert not res.converged and res.iterations == 2
    assert len(res.history) == 2


@pytest.mark.parametrize("exit_,cfg_kw,jitter", [
    # the iterate sits below stall_accept_rel and stops improving
    ("accept_rel", {"stall_flat_factor": 1.0, "stall_dx_rtol": 0.0}, 1e-9),
    # the last update is negligible against |x|
    ("dx", {"stall_accept_rel": 0.0, "stall_flat_factor": 1.0}, 0.0),
    # the residual is flat at its best value
    ("flat", {"stall_accept_rel": 0.0, "stall_dx_rtol": 1e-300}, 1e-9),
])
def test_newton_stall_exits_match(exit_, cfg_kw, jitter):
    cfg_kw = {"abs_tol": 1e-12, "rel_tol": 1e-14, "max_iter": 30, **cfg_kw}
    res = _same(*_run_both(cfg_kw, floor=1e-6, jitter=jitter))
    assert res.converged and res.stalled, exit_
    assert res.iterations < 30
    assert abs(res.final_residual - 1e-6) < 1e-7
    # with every stall exit disabled the same run reaches the cap
    off = {**cfg_kw, "stall_accept_rel": 0.0, "stall_flat_factor": 1.0,
           "stall_dx_rtol": 0.0 if jitter else 1e-300}
    if exit_ != "dx":
        capped = _same(*_run_both(off, floor=1e-6, jitter=jitter))
        assert not capped.converged and capped.iterations == 30


def test_newton_default_dx_rtol_is_30_eps_of_the_dtype():
    """A float32 run whose residual floors: stalled by the dx criterion with
    the default stall_dx_rtol (30 eps of float32)."""
    A, b, noise = (torch.as_tensor(a, dtype=torch.float32)
                   for a in _system())
    F = lambda x: A @ x + x ** 3 - b
    x, res = newton.newton_solve(
        lambda x: F(x) + 1e-3 * noise, torch.zeros(_N, dtype=torch.float32),
        lambda x, rhs, jac: direct.dense_solve(jac, -F(x)),
        newton.NewtonConfig(abs_tol=1e-12, rel_tol=1e-14, max_iter=30,
                            stall_accept_rel=0.0, stall_flat_factor=1.0),
        rebuild_jacobian=lambda x: A + torch.diag(3.0 * x ** 2))
    assert x.dtype == torch.float32 and res.converged and res.stalled


@pytest.mark.parametrize("exit_,res_seq,upd,cfg_kw,checks", [
    # below stall_accept_rel (5e-4 of r0 = 10), then two checks unimproved
    ("accept_rel", [10.0, 1.0] + [5e-3] * 10, 1.0,
     {"stall_flat_factor": 1.0, "stall_dx_rtol": 0.0}, 5),
    # the last update negligible against |[T; p]| (30 eps by default)
    ("dx", [10.0] + [8.0] * 11, 1e-20,
     {"stall_accept_rel": 0.0, "stall_flat_factor": 1.0}, 4),
    # flat within 1.15 of its best for two checks
    ("flat", [10.0, 1.0, 1.0, 1.05] + [1.02] * 8, 1.0,
     {"stall_accept_rel": 0.0, "stall_dx_rtol": 1e-300}, 4),
    # an oscillation above 1.15 of the best never stalls: the cap
    ("oscillating", [10.0, 1.0, 1.0, 5.0, 1.1] * 3, 1.0,
     {"stall_accept_rel": 0.0, "stall_dx_rtol": 1e-300}, 12),
])
def test_host_and_scan_stall_rules_agree(exit_, res_seq, upd, cfg_kw,
                                         checks):
    """``StallWindow`` (the host loops' rule) and ``scan_newton``'s tensor
    rule stop a scripted residual history at the same check, stalled or
    at the cap alike."""
    from cmfem_tpu_torch.apps.common import scan_newton

    cfg = newton.NewtonConfig(abs_tol=1e-30, rel_tol=1e-30, max_iter=12,
                              **cfg_kw)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    T, p = f64([1.0, 1.0]), f64([0.0, 0.0])
    calls = []

    def residual(T, p):
        calls.append(None)
        return f64([res_seq[len(calls) - 1]])

    out = scan_newton(T, p, residual=residual,
                      solve=lambda T, p, R: (T, p, f64(upd), True),
                      config=cfg)
    window = newton.StallWindow(cfg, torch.float64)
    for k, rn in enumerate(res_seq[:cfg.max_iter]):
        stalled = window.update(rn, rn / max(1.0, res_seq[0]),
                                float(np.sqrt(2.0)))
        if stalled:
            break
        window.un_prev = upd
    assert (out[2], out[5], bool(out[9])) == (k + 1, stalled, stalled)
    assert k + 1 == checks and stalled == (exit_ != "oscillating")
