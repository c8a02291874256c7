"""The eager time loop of the ablation drivers (cases 1, 2.1 and 2.2).

``run(case_cls, cfg, device, dtype, option=None, nranks=0)`` is each
driver's eager path, in one process or on one rank of a world of
``nranks`` (``option``: ``apps.distributed``): the ``run_setup`` span (the
case, the linear solver, the start and its outputs), then each step in the
``step`` span (the case's work before the solve, the ``state`` and ``bc``
phases, the Jacobian check, ``run_tp_newton_loop``, the state advance, the
``output`` phase, the progress line), then the ``run_finish`` span.  The
case class (``Case1``, ``Case21``, ``Case22``) supplies what differs, as
methods: ``start``, ``stepping``, ``restart_writer``, ``boundary``,
``move_mesh``, ``step_args``, ``distributed``, ``newton_instance``,
``check_jacobians``, ``write_outputs``, ``progress``, ``timing_row``,
``finish`` and ``results``.

Each timing row holds the step's phases, their ``total``, ``newton``,
``step_wall`` (the step's whole wall time), ``host_syncs`` (the times the
step made the host wait for the device) and the case's counters; the first
row also holds ``run_setup`` and the last ``run_finish``, in seconds.
"""

from __future__ import annotations

import time as _time
from typing import NamedTuple

import torch

from .common import (device_sync, load_newton_config,
                     make_block_linear_solver, run_tp_newton_loop)
from ..utils.timing import StepTimer, host_sync

TIMING_KEYS = ("bc", "residual", "jacobian", "factorization", "linear",
               "update", "state", "output")


class Step(NamedTuple):
    """A step's frozen inputs: the old T and p at the quadrature points,
    the old extents, dt, the boundary (``boundary``) and the geometry
    (``move_mesh``)."""
    T_old_q: torch.Tensor
    p_old_q: torch.Tensor
    X_old: torch.Tensor
    dt: float
    bnd: tuple
    g: object


def run(case_cls, cfg, device, dtype, option=None, nranks=0):
    run_t0 = _time.perf_counter()
    timer = StepTimer(sync=device_sync(device))
    with timer.span("run_setup"):
        c = case_cls(cfg, device, dtype)
        sys_, ops, n = c.sys, c.ops, c.n
        newton_cfg = load_newton_config(cfg)
        print_level = int(cfg.get("newton_print_level", 1))
        rebuild_freq = max(1, int(cfg.get("newton_jacobian_rebuild_freq",
                                          1)))
        jacobian_check = bool(cfg.get("jacobian_check", False))
        jc_tol = (float(cfg.get("jacobian_check_abs_tol", 1e-6)),
                  float(cfg.get("jacobian_check_rel_tol", 1e-4)))
        dn = None
        if nranks:
            iter_factory = dn = c.distributed(option, nranks)
        else:
            iter_factory = make_block_linear_solver(
                cfg, c.fes.element_dofs, n, c.ess_T, c.ess,
                node_positions=c.fes.node_positions, device=device)
        step, t, T, p, state = c.start()
        write_restart, write_restart_at_end = c.restart_writer(t)
        c.write_outputs(step, t, T, p, state)
    # the rows are the steps': what the set-up counted is dropped
    timer.step_reset()
    jc_results = {}
    timing, newton_iters, krylov = [], [], []
    while c.stepping(step, t):
        with timer.span("step"):
            step += 1
            t_prev = t
            t = min(c.t_final, t + c.dt)
            dt = t - t_prev
            bnd = c.boundary(t)
            state, g = c.move_mesh(timer, T, p, state, t, dt, bnd)
            with timer.phase("state"):
                s = Step(ops.values_at_qp(T), ops.values_at_qp(p),
                         state.extent, dt, bnd, g)
                if dn is not None:
                    inst, face_bc = c.newton_instance(dn, s)
            with timer.phase("bc"):
                T, p = c.enforce_bc(T, p, bnd[0], t)
            if jacobian_check:
                c.check_jacobians(T, p, s, step, jc_tol, jc_results)
            args = c.step_args(s)

            def residual(T, p):
                if dn is not None:
                    return dn.residual(inst, T, p, dt, bc=face_bc)
                return c.residual(T, p, *args)

            def factorize(T, p):
                with timer.phase("jacobian"):
                    if dn is not None:
                        return dn.factorize(inst, T, p, dt, bc=face_bc)
                    blocks, face = c.jacobians(T, p, *args,
                                               phase=timer.phase)
                with timer.phase("factorization"):
                    if iter_factory is not None:
                        return iter_factory(blocks, face=face,
                                            face_elem=sys_.trace.elem)
                    return c.host_lu(blocks, face)

            nsolve0 = len(iter_factory.results) if iter_factory else 0
            T, p, iters, ntim = run_tp_newton_loop(
                T, p, residual=residual, factorize=factorize,
                enforce_bc=lambda T, p: c.enforce_bc(T, p, bnd[0], t),
                newton_cfg=newton_cfg, rebuild_freq=rebuild_freq,
                newton_csv=c.newton_csv, step=step, t=t, n=n, timer=timer,
                print_level=print_level,
                print_multiline=c.NEWTON_PRINT_MULTILINE)
            rec = timer.step_reset()
            # the loop's Jacobian time holds the Jacobians and the
            # factorization, timed apart inside factorize
            rec.update(residual=ntim["nres"], linear=ntim["nlin"],
                       update=ntim["nupd"])
            with timer.phase("state"):
                state = sys_.advance_state(state, T, p, dt)
            with timer.phase("output"):
                c.write_outputs(step, t, T, p, state)
                write_restart(step, t_prev, t, T, p, state.extent)
            c.progress(step, t, bnd, iters, T, state)
            rec.update({k: rec.get(k, 0.0) + v
                        for k, v in timer.step_reset().items()})
            timing.append(c.timing_row(step, rec))
            newton_iters.append(iters)
            if iter_factory is not None:
                krylov.append([r.inner_iters
                               for r in iter_factory.results[nsolve0:]])
        rec["step_wall"] = timer.spans["step"]

    with timer.span("run_finish"):
        write_restart_at_end(step, t, T, p, state.extent)
        totals = {k: sum(r.get(k, 0.0) for r in timing)
                  for k in TIMING_KEYS + ("newton", "total")}
        metrics = c.finish(totals, _time.perf_counter() - run_t0)
        host_sync(2)
        out = {"T": T.cpu().numpy(), "p": p.cpu().numpy(), "state": state,
               "fes": c.fes, "mesh": c.mesh, **c.results(step, t, metrics),
               "converged": True, "timing": timing,
               "newton_iters": newton_iters}
    run_spans(timing, timer)
    if iter_factory is not None:
        out["krylov_iters"] = krylov
    if jacobian_check:
        out["jacobian_check"] = jc_results
    return out


def run_spans(timing, timer):
    """The run's set-up into its first timing row and its finish into its
    last (seconds)."""
    if timing:
        timing[0]["run_setup"] = timer.spans["run_setup"]
        timing[-1]["run_finish"] = timer.spans["run_finish"]
