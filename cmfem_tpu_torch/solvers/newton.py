"""Newton harness mirroring the reference's PetscNewtonSolver semantics.

Port of ``cmfem_tpu/solvers/newton.py``:
- abs/rel residual convergence with r0 = max(1, |R0|)
- Jacobian rebuild frequency
- BC re-enforcement after each update
- per-iteration logging records
- per-phase wall-clock timing
- the three working-precision stall exits

The residual, the Jacobian state and the linear solve are the caller's
(``residual_fn``, ``rebuild_jacobian``, ``solve_linear``); the harness is a
host loop over tensors on any device.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


@dataclass
class NewtonConfig:
    abs_tol: float = 1.0e-10
    rel_tol: float = 1.0e-8
    max_iter: int = 20
    jacobian_rebuild_freq: int = 1
    # Working-precision stall exit (a float32 run of the decks' float64
    # tolerances floors near rel ~1e-5 on the ablation systems).  When the
    # residual norm fails to improve by ``stall_improve`` relative to
    # the best seen for ``stall_patience`` consecutive iterations AND
    # the iterate already sits below ``stall_accept_rel`` relative
    # residual, the iterate is accepted as converged-at-floor.  A
    # genuinely diverging solve (rel >= stall_accept_rel) never
    # stall-exits and still fails fast at max_iter.  Set
    # stall_accept_rel = 0 to disable.
    stall_improve: float = 1.0e-3
    stall_patience: int = 2
    stall_accept_rel: float = 1.0e-3
    # second acceptance criterion for steps that START at the floor
    # (r0 ~ rn so the relative test can never fire): accept when the
    # last Newton update was numerically negligible, |dx| <=
    # stall_dx_rtol * |x|.  None -> 30 eps of the working dtype.
    stall_dx_rtol: float | None = None
    # third acceptance criterion — residual FLATNESS at the evaluation
    # floor.  At small dt the BE storage terms amplify f32 rounding by
    # 1/dt while the per-step residual signal shrinks by dt, so the f32
    # evaluation floor can sit only a few times below the step's
    # initial residual, and rel-based acceptance can never fire.  After
    # one exact linear solve the iterate IS the
    # f64 Newton iterate to working precision; the f32 residual just
    # cannot see it.  Accept when the residual has been FLAT at its
    # best pre-update value — max(residuals since the last improvement)
    # <= stall_flat_factor * rbest — for ``stall_patience`` consecutive
    # non-improving iterations.  Judging the window MAXIMUM against the
    # best BEFORE the current residual is absorbed means a diverging or
    # oscillating solve (residuals 1.0, 5.0, 1.1) never flat-exits on a
    # dip; it still fails fast at max_iter.  Set <= 1 to disable this
    # criterion (values in (0, 1] would otherwise still fire on an
    # exactly flat residual, since rbest bounds the window max from
    # below — so the implementation disables the whole test there).
    stall_flat_factor: float = 1.15


@dataclass
class NewtonIterationInfo:
    iter: int = 0
    residual_norm: float = 0.0
    residual_norm0: float = 1.0
    relative_residual: float = 0.0
    update_norm: float = 0.0
    update_norm0: float = 1.0
    relative_update: float = 0.0
    converged: bool = False


@dataclass
class NewtonTiming:
    solve_sec: float = 0.0
    residual_eval_sec: float = 0.0
    jacobian_sec: float = 0.0
    linear_sec: float = 0.0
    update_sec: float = 0.0


@dataclass
class NewtonResult:
    converged: bool = False
    iterations: int = 0
    final_residual: float = float("inf")
    initial_residual: float = 1.0
    final_relative_residual: float = float("inf")
    final_update_norm: float = 0.0
    initial_update_norm: float = 1.0
    final_relative_update: float = 0.0
    timing: NewtonTiming = field(default_factory=NewtonTiming)
    history: List[NewtonIterationInfo] = field(default_factory=list)
    # converged came from a working-precision stall-acceptance exit,
    # not the abs/rel tolerance (drivers surface these distinctly)
    stalled: bool = False


class StallWindow:
    """The working-precision stall exits of ``NewtonConfig`` on host floats,
    for the host Newton loops (``newton_solve``, ``apps.common``'s
    ``run_tp_newton_loop``; ``scan_newton`` keeps them as device tensors).
    ``update`` takes each residual check and says whether the iterate
    stalled at the floor; ``un_prev`` holds the last update's norm."""

    def __init__(self, config: NewtonConfig, dtype):
        self.config = config
        self.dx_rtol = config.stall_dx_rtol
        if self.dx_rtol is None:
            self.dx_rtol = 30.0 * float(torch.finfo(dtype).eps)
        self.rbest = self.rmax = self.un_prev = float("inf")
        self.noimp = 0

    def update(self, res_norm, rel_res, xnorm):
        """Absorb the residual norm ``res_norm`` (``rel_res`` relative) of
        the iterate of norm ``xnorm``; True when it stalled."""
        c = self.config
        rbest_pre = self.rbest
        improved = res_norm < (1.0 - c.stall_improve) * self.rbest
        self.noimp = 0 if improved else self.noimp + 1
        # max residual over the current non-improving window, against the
        # best before this one: an oscillating divergence never flat-exits
        # on a dip
        self.rmax = res_norm if improved else max(self.rmax, res_norm)
        self.rbest = min(self.rbest, res_norm)
        flat_ok = (c.stall_flat_factor > 1.0
                   and self.rmax <= c.stall_flat_factor * rbest_pre)
        return self.noimp >= c.stall_patience and (
            rel_res < c.stall_accept_rel
            or self.un_prev <= self.dx_rtol * xnorm or flat_ok)


def _sync(t):
    """Wait for the device behind a CUDA tensor, so that a phase's
    wall-clock time is the phase's (``jax.block_until_ready``)."""
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def newton_solve(
    residual_fn: Callable,
    x0,
    solve_linear: Callable,
    config: NewtonConfig = NewtonConfig(),
    enforce_bc: Optional[Callable] = None,
    log_iteration: Optional[Callable] = None,
    rebuild_jacobian: Optional[Callable] = None,
):
    """Damping-free Newton loop.

    residual_fn(x) -> R(x)
    solve_linear(x, rhs, jac_state) -> dx solving J(x) dx = rhs
    rebuild_jacobian(x) -> jac_state  (optional; called per rebuild_freq)
    enforce_bc(x) -> x  re-applied after each update
    """
    x = x0
    result = NewtonResult()
    t_solve0 = _time.perf_counter()
    r0 = 1.0
    du0 = 1.0
    jac_state = None
    freq = max(1, config.jacobian_rebuild_freq)
    window = StallWindow(config, x.dtype)

    for it in range(config.max_iter):
        t0 = _time.perf_counter()
        R = residual_fn(x)
        _sync(R)
        result.timing.residual_eval_sec += _time.perf_counter() - t0

        res_norm = float(torch.linalg.vector_norm(R))
        if it == 0:
            r0 = max(1.0, res_norm)
            result.initial_residual = r0
        rel_res = res_norm / r0 if r0 > 0 else res_norm
        result.final_residual = res_norm
        result.final_relative_residual = rel_res

        stalled = window.update(res_norm, rel_res,
                                float(torch.linalg.vector_norm(x)))
        tol_done = res_norm < config.abs_tol or rel_res < config.rel_tol

        if tol_done or stalled:
            result.converged = True
            result.stalled = stalled and not tol_done
            result.iterations = it
            info = NewtonIterationInfo(
                iter=it, residual_norm=res_norm, residual_norm0=r0,
                relative_residual=rel_res, update_norm=0.0,
                update_norm0=du0, relative_update=0.0, converged=True,
            )
            result.history.append(info)
            if log_iteration:
                log_iteration(info)
            break

        if rebuild_jacobian is not None and (it % freq == 0 or jac_state is None):
            t0 = _time.perf_counter()
            jac_state = rebuild_jacobian(x)
            _sync(x)
            result.timing.jacobian_sec += _time.perf_counter() - t0

        t0 = _time.perf_counter()
        dx = solve_linear(x, -R, jac_state)
        _sync(dx)
        result.timing.linear_sec += _time.perf_counter() - t0

        t0 = _time.perf_counter()
        update_norm = float(torch.linalg.vector_norm(dx))
        window.un_prev = update_norm
        if it == 0:
            du0 = max(1.0, update_norm)
            result.initial_update_norm = du0
        rel_update = update_norm / du0 if du0 > 0 else update_norm
        x = x + dx
        if enforce_bc is not None:
            x = enforce_bc(x)
        result.timing.update_sec += _time.perf_counter() - t0
        result.final_update_norm = update_norm
        result.final_relative_update = rel_update

        info = NewtonIterationInfo(
            iter=it, residual_norm=res_norm, residual_norm0=r0,
            relative_residual=rel_res, update_norm=update_norm,
            update_norm0=du0, relative_update=rel_update, converged=False,
        )
        result.history.append(info)
        if log_iteration:
            log_iteration(info)

    if not result.converged:
        result.iterations = config.max_iter
    result.timing.solve_sec = _time.perf_counter() - t_solve0
    return x, result
