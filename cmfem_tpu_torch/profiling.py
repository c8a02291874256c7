"""Where the time of slices 2, 3, 6 to 11's paths goes, on one GPU.

    python -m cmfem_tpu_torch.profiling [--n 48] [--out FILE]
                                        [--sections operators,vcycle,...]

Profiles, with ``torch.profiler`` (host and device activity), at n^3
order-2 elements:

- one apply of each B1 operator: ``structured-pa`` (lattice gather, the
  B^T D B kernel, lattice scatter), the lattice gather and scatter alone,
  and ``pa`` (``u[eldofs_T]``, the kernel, ``index_add_``), float32;
- one warm GMRES backward-Euler step of ``vc_entry`` through each of the
  three operators, float32;
- one StructuredMG V-cycle of ``mg_solve``'s problem, float64, and each
  level's operator apply alone (host clock, device synchronized);
- one ``sumfact-zchain`` and one ``sumfact-zchain-periodic`` apply of
  ``operator_paths``, float32: how the device time splits between the
  z-chain kernel and the torch x/y matmuls around it;
- the steps of the ``linear_cd_transient`` driver (section ``driver``) on
  64 x 64 quads refined twice, order 2, float64, dt = 1e-3: the driver is
  run whole for 1 step and for 4 steps, each under the profiler (device
  activity only), and the difference is three steps' wall and device busy
  time with the set-up taken out; the same with ``scan_stepping``;
- one backward-Euler step of the ``nonlinear_diffusion`` driver (section
  ``nonlinear``, chip_smoke's phase 10a: 128 x 128 quads of side 0.01,
  order 2, float64, dt = 0.1): the driver run whole for 1 and for 2 steps,
  differenced, and its own clock's split of the step; then, on the same
  form at the step's solution, the residual, the Jacobian diagonal (vmapped
  jacfwd element Jacobians and their scatter), one JVP by
  ``torch.func.jvp`` and by ``torch.func.linearize`` (its trace, then one
  apply) alone, and the step's split into residuals, element Jacobians,
  linearize traces, JVP applies and the rest of GMRES (host work) from
  those times and the step's counts;
- the elasticity driver's 2D default solved 12 times (section
  ``elasticity_cg``) with the vector forms' fixed-order scatter and with an
  ``index_add_`` scatter in its place: the CG iterations of each solve and
  how many stop early;
- one step of the ablation case-1 driver (section ``ablation``) through
  ``scan_stepping`` on chip_smoke's phase-11 strip (11 x 239 quads, graded
  toward the heated top) with the synthetic TACOT deck, unrefined and
  refined twice, float64: the driver run whole for 1 and for 2 steps,
  differenced, and each piece alone at the run's final state — residual,
  ``vmap(jacfwd)`` element Jacobians, block-QR factorization, banded solve
  with its GMRES, the host ``splu`` path, state advance;
- the first Newton system of that step (section ``linemg``; chip_smoke
  phase 14a's two systems, 5,760 and 86,130 DOFs) through GMRES(400) at
  rtol 1e-12 with the line-multigrid and the point-block preconditioners:
  inner iterations, set-up and solve time, the true residual and the
  direction against the block-tridiagonal direct solve;
- the line-multigrid kernels at every level of that system's hierarchy
  (section ``linemg_levels``; the strip refined 0, 2 and 3 times): each
  level's NY x NX, ``line_factor`` and ``line_solve`` device ms per call
  (a replayed CUDA graph, median of 20) and ms per call (CUDA events
  around one call, the host's enqueue included) beside their bounds,
  float64; the same on seeded line systems as tall as the strip refined 5
  times (section ``linemg_tall``, NY = 7,649, where the solve's rows reach
  past shared memory), with their line residual;
- one step of the ablation case-2.1 driver (section ``ablation_case21``) on
  the same strip with the synthetic B' table and the schedule fixture,
  through the eager host-LU path and ``scan_stepping``, differenced as
  above, and its pieces alone: the domain residual, the SEB face residual
  and the B' lookup inside it, the element and face Jacobians, the host
  ``splu`` with the face blocks, the block-QR factorization, the banded
  solve and one diagnostics row;
- one step of the ablation case-2.2 driver (section ``ablation_case22``)
  on the same strip split into triangles, through both paths, differenced
  as above, and its pieces alone (``case22_pieces``): the recession
  velocity, the smoothing CG started cold and warm, the device remap, the
  quality metric, the residual, the element and face Jacobians, the
  block-QR factorization, the banded solve and one step's diagnostics.

For each it prints the host wall per repetition (profiled, and unprofiled
where stated), the device busy time (the sum of the device activities'
own times: kernels and copies, one stream), the idle share 1 - busy/wall
and the device activities that take most time.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import require_cuda
from .apps import linear_cd_transient, nonlinear_diffusion
from .core import make_cartesian_mesh_2d, write_gmsh
from .entry import KAPPA, OPERATORS, operator_paths, vc_entry
from .ops import BilinearForm
from .solvers.multigrid import StructuredMG


def _sync():
    torch.cuda.synchronize()


def host_ms(fn, reps=20, warmup=3):
    """Median host-clock ms of ``fn()`` with the device synchronized."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def profiled(label, fn, reps, out, top=12):
    """Profile ``reps`` calls of ``fn()`` (warmed once) and print the
    per-repetition wall, device busy time, idle share and top activities."""
    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    out(f"== {label}: wall {wall:.3f} ms/rep (profiled), device busy "
        f"{busy:.3f} ms/rep, idle share {1 - busy / wall:.3f}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        out(f"   {e.self_device_time_total / 1e3 / reps:9.3f} ms "
            f"{e.count / reps:8.1f} calls/rep  {e.key[:90]}")
    return wall, busy


def profile_operators(n, dev, rng, out):
    """B1 operator applies and the three vc GMRES steps."""
    for name in OPERATORS:
        step, (u0, *arrays) = vc_entry(n=n, order=2, operator=name,
                                       device=dev)
        out(f"-- vc_entry(n={n}, order=2, operator={name!r}) via {step.path}")
        u = torch.as_tensor(rng.standard_normal(u0.shape[0]),
                            dtype=u0.dtype, device=dev)
        profiled(f"{name} apply", lambda: step.fn(u, *arrays), 20, out)
        if name == "structured-pa":
            grid = step.op.grid
            u_eT = grid.gather(u)
            profiled("lattice gather only", lambda: grid.gather(u), 20, out)
            profiled("lattice scatter only", lambda: grid.scatter(u_eT), 20,
                     out)
        out(f"   {name} GMRES step unprofiled: "
            f"{host_ms(lambda: step(u0, *arrays), reps=5, warmup=1):.3f} "
            "ms")
        profiled(f"{name} GMRES step", lambda: step(u0, *arrays), 1, out)
        del step, u0, arrays, u
        torch.cuda.empty_cache()


def profile_vcycle(n, dev, rng, out):
    """One float64 V-cycle and each level's apply."""
    mg = StructuredMG.build(n, 2, lambda ops: BilinearForm(ops)
                            .add_diffusion(KAPPA), device=dev,
                            dtype=torch.float64)
    M, arrs = mg.bind()
    r = torch.as_tensor(rng.standard_normal(mg.levels[0]["diag"].shape[0]),
                        device=dev)
    out(f"-- StructuredMG n={n} order 2 f64, fine level via {mg.fine_path}; "
        f"V-cycle unprofiled {host_ms(lambda: M(r, arrs), reps=5):.3f} ms")
    profiled("one V-cycle f64", lambda: M(r, arrs), 1, out)
    for k, lvl in enumerate(mg.levels):
        fn, D, path = (lvl["op"].best_bind() if k == 0
                       else (*lvl["op"].bind(), "plain-chain"))
        v = torch.ones(lvl["diag"].shape[0], dtype=torch.float64, device=dev)
        out(f"   level {k} shape {lvl['shape']} {path}: apply "
            f"{host_ms(lambda: fn(v, D)):.3f} ms (host clock)")


def profile_zchain(n, dev, rng, out):
    """The z-chain applies of operator_paths at order 2."""
    P = operator_paths(n=n, order=2, device=dev)
    u = torch.as_tensor(rng.standard_normal(P.ndofs), dtype=torch.float32,
                        device=dev)
    for name in ("sumfact-zchain", "sumfact-zchain-periodic"):
        fn, arrays = P.paths[name]
        out(f"-- operator_paths(n={n}, order=2) {name}")
        profiled(f"{name} apply", lambda: fn(u, *arrays), 20, out)


def device_busy(fn):
    """(wall ms, device busy ms, value) of one call of ``fn()`` under the
    profiler, device activity only (the host side of a whole driver run is
    seconds of numpy)."""
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        _sync()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy, value


def profile_driver(n, dev, rng, out, n_quads=64, ref=2):
    """The steps of the linear_cd_transient driver, set-up differenced out."""
    with tempfile.TemporaryDirectory() as tmp:
        mesh = write_gmsh(make_cartesian_mesh_2d(n_quads, n_quads),
                          os.path.join(tmp, "quads.msh"))
        cfg = {"mesh_file": mesh, "serial_ref_levels": ref, "order": 2,
               "dt": 1e-3, "save_paraview": False,
               "output_path": os.path.join(tmp, "out")}
        run = lambda steps, scan: linear_cd_transient.run(
            {**cfg, "t_final": steps * 1e-3, "scan_stepping": scan},
            device=dev)
        run(1, False)  # warm: handles, allocator
        for scan in (False, True):
            w1, b1, _ = device_busy(lambda: run(1, scan))
            w4, b4, r = device_busy(lambda: run(4, scan))
            wall, busy = (w4 - w1) / 3, (b4 - b1) / 3
            steps = r["timing"][1:]
            out(f"== linear_cd_transient {'scan_stepping' if scan else 'host loop'}"
                f" ({r['fes'].nscalar} DOFs x 3 Peclet cases, f64): steps "
                f"2-4 wall {wall:.1f} ms/step, device busy {busy:.1f} "
                f"ms/step, idle share {1 - busy / wall:.3f}; whole runs "
                f"{w1:.0f} ms (1 step) and {w4:.0f} ms (4 steps); the "
                f"driver's own clock: solve "
                f"{1e3 * statistics.mean(t['solve'] for t in steps):.1f} "
                f"ms/step, errors and output "
                f"{1e3 * statistics.mean(t['errors_io'] for t in steps):.1f}"
                f" ms/step; Arnoldi steps per step "
                f"{sum(r['arnoldi']) / 4:.0f}")


def profile_nonlinear(n, dev, rng, out, n_quads=128):
    """One step of the nonlinear_diffusion driver and its AD pieces alone."""
    import warnings

    from .core import FESpace
    from .ops import SpaceOps
    from .ops.nonlinear import NonlinearForm

    with tempfile.TemporaryDirectory() as tmp:
        mesh = write_gmsh(make_cartesian_mesh_2d(n_quads, n_quads, sx=0.01,
                                                 sy=0.01),
                          os.path.join(tmp, "square.msh"))
        cfg = {"mesh_file": mesh, "order": 2, "dt": 0.1, "L": 0.01,
               "series_terms": 400, "save_paraview": False,
               "newton_print_level": 0,
               "output_path": os.path.join(tmp, "out")}
        run = lambda steps: nonlinear_diffusion.run(
            {**cfg, "t_final": steps * 0.1}, device=dev)
        run(1)  # warm: the AD transforms' first use, handles, allocator
        w1, b1, _ = device_busy(lambda: run(1))
        w2, b2, r = device_busy(lambda: run(2))
    wall, busy = w2 - w1, b2 - b1
    step = r["timing"][1]
    newton = r["newton_iters"][1]
    gmres_its = r["krylov_iters"][1]
    out(f"== nonlinear_diffusion ({r['fes'].nscalar} DOFs, f64) step 2: "
        f"wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}; {newton} Newton iterations, GMRES "
        f"iterations {gmres_its}; whole runs {w1:.0f} ms (1 step) and "
        f"{w2:.0f} ms (2 steps); the driver's own clock, ms: "
        + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in step.items()))

    # the pieces alone, on the same form at the step's solution
    fes = FESpace(make_cartesian_mesh_2d(n_quads, n_quads, sx=0.01,
                                         sy=0.01), 2)
    ops = SpaceOps(fes, device=dev)
    nlf = NonlinearForm(ops, nonlinear_diffusion.heat_qp_residual(
        8000.0 * 500.0, 8000.0 * 4.5, 10.0, 0.09, 300.0, 0.1))
    u = torch.as_tensor(r["u"], device=dev)
    aux = {"u_old_q": ops.values_at_qp(u)}
    v = torch.as_tensor(rng.standard_normal(fes.nscalar), device=dev)

    def piece(label, fn, reps, top=6):
        """(unprofiled host ms, profiled device busy ms) of one call."""
        ms = host_ms(fn, reps=reps, warmup=2)
        _, busy = profiled(label, fn, reps, out, top=top)
        out(f"   {label}: unprofiled {ms:.3f} ms per call (host clock, "
            "device synchronized)")
        return ms, busy

    res_ms, res_busy = piece("residual", lambda: nlf.residual(u, **aux), 20,
                             top=4)
    jac_ms, jac_busy = piece(
        "Jacobian diagonal (vmap(jacfwd) element Jacobians + scatter)",
        lambda: nlf.jacobian_diagonal(u, **aux), 10)
    jvp_ms, jvp_busy = piece("JVP by torch.func.jvp",
                             lambda: nlf.jvp(u, v, **aux), 20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # const_fold's get_attr notes
        lin_ms, _ = piece("torch.func.linearize (trace at one iterate)",
                          lambda: nlf.linearize(u, **aux), 3, top=4)
        _, lin_fn = nlf.linearize(u, **aux)
    lapp_ms, lapp_busy = piece("one apply of linearize's JVP",
                               lambda: lin_fn(v), 20)
    # the driver: per Newton iterate a residual, a Jacobian diagonal and a
    # linearize trace; per GMRES iteration one apply of the traced JVP (and
    # two per restart cycle's explicit residual, counted at two per solve)
    n_jvp = sum(gmres_its) + 2 * len(gmres_its)
    split = {"residuals": (newton + 1) * res_ms,
             "element Jacobians": newton * jac_ms,
             "linearize traces": newton * lin_ms,
             "JVP applies": n_jvp * lapp_ms}
    split["GMRES host work and the rest"] = wall - sum(split.values())
    out(f"== step 2 split (ms, from the times alone x counts: {newton + 1} "
        f"residuals, {newton} Jacobian diagonals and linearize traces, "
        f"{n_jvp} JVP applies): "
        + ", ".join(f"{k} {v:.1f} ({v / wall:.1%})" for k, v in split.items())
        + f"; device busy of the JVP applies {n_jvp * lapp_busy:.1f} ms, of "
        f"the Jacobians {newton * jac_busy:.1f} ms")
    per_newton = n_jvp / max(1, newton)
    out(f"== JVP choice at this step's {per_newton:.1f} JVPs per Newton "
        f"iteration: torch.func.jvp {per_newton * jvp_ms:.1f} ms per Newton "
        f"iteration, linearize {lin_ms + per_newton * lapp_ms:.1f} ms (trace "
        f"{lin_ms:.1f} + {lapp_ms:.3f} per apply; even at "
        f"{lin_ms / max(1e-9, jvp_ms - lapp_ms):.0f} JVPs); device busy per "
        f"JVP {jvp_busy:.3f} against {lapp_busy:.3f} ms")


def profile_elasticity_cg(n, dev, rng, out, reps=12):
    """The elasticity driver's 2D default solved ``reps`` times with the
    vector forms' fixed-order scatter, then with an ``index_add_`` scatter
    (atomics on the GPU) in its place: how often Jacobi-CG stops early."""
    from .apps import elasticity
    from .ops import vector

    fixed = vector._scatter_components

    def atomic(y_e, slots):
        v, numel = y_e.shape[-1], y_e.shape[0] * y_e.shape[1]
        rows = torch.arange(slots.shape[0], device=slots.device)
        valid = slots < numel
        dof = torch.empty(numel, dtype=torch.int64, device=slots.device)
        dof[slots[valid]] = rows[:, None].expand_as(slots)[valid]
        out_ = y_e.new_zeros((slots.shape[0], v))
        return out_.index_add_(0, dof, y_e.reshape(-1, v)).T.reshape(-1)

    with tempfile.TemporaryDirectory() as tmp:
        for name, scatter in (("fixed-order scatter", fixed),
                              ("index_add_ scatter", atomic)):
            vector._scatter_components = scatter
            runs = []
            try:
                for _ in range(reps):
                    try:
                        r = elasticity.run({"dim": 2, "save_paraview": False,
                                            "output_path": tmp}, device=dev)
                        runs.append(f"{r['iters']} ({r['solve'].rel_residual:.2e})")
                    except RuntimeError as e:
                        runs.append("stopped: " + str(e).split(" — ")[0])
            finally:
                vector._scatter_components = fixed
            stops = sum(r.startswith("stopped") for r in runs)
            out(f"== elasticity 2D default, {name}: {stops} of {reps} solves "
                f"stopped early; CG iterations (final rel residual): {runs}")


DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "tacot_synthetic.json")


def profile_ablation(n, dev, rng, out, nx=11, ny=239, ref_levels=(0, 2)):
    """One step of the ablation case-1 driver (``scan_stepping``, the block-QR
    solver on the card) on chip_smoke's graded strip with the synthetic
    TACOT deck, unrefined and refined twice: the driver run whole for 1 and
    for 2 steps under the profiler, differenced; then each piece alone at the
    run's final state (host ms with the device synchronized, and device
    busy): the residual, the ``vmap(jacfwd)`` element Jacobians, the
    block-QR factorization, the banded solve with its GMRES, the host
    ``splu`` path's assembly and factorization and one LU solve, and the
    state advance."""
    from .apps import ablation_case1
    from .core import make_strip_mesh_2d
    from .solvers.blocksolve import make_scan_block_solver

    def piece(label, fn, reps, top=5):
        ms = host_ms(fn, reps=reps, warmup=1)
        profiled(label, fn, reps, out, top=top)
        out(f"   {label}: unprofiled {ms:.3f} ms per call (host clock, "
            "device synchronized)")

    with tempfile.TemporaryDirectory() as tmp:
        strip = write_gmsh(make_strip_mesh_2d(nx, ny),
                           os.path.join(tmp, "strip.msh"))
        for ref in ref_levels:
            cfg = {"mesh_file": strip, "material_file": DECK, "order": 1,
                   "dt": 0.1, "bdr_attr_top": 3, "probe_x": 0.00125,
                   "serial_ref_levels": ref, "newton_print_level": 0,
                   "save_paraview": False, "scan_stepping": True,
                   "output_path": os.path.join(tmp, f"out{ref}")}
            run = lambda steps: ablation_case1.run(
                {**cfg, "t_final": steps * 0.1}, device=dev)
            if ref == ref_levels[0]:
                run(1)  # warm: the AD transforms' first use, the allocator
            w1, b1, _ = device_busy(lambda: run(1))
            w2, b2, r = device_busy(lambda: run(2))
            wall, busy = w2 - w1, b2 - b1
            out(f"== ablation_case1 scan_stepping, {2 * r['fes'].nscalar} "
                f"DOFs (strip {nx} x {ny} refined {ref}x), step 2: wall "
                f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share "
                f"{1 - busy / wall:.3f}; {r['newton_iters'][1]} Newton "
                f"solves; the driver's own clock, ms: "
                + ", ".join(f"{k} {1e3 * v:.1f}"
                            for k, v in r["timing"][1].items()))
            c = ablation_case1.Case1({**cfg, "t_final": 0.1}, dev,
                                     torch.float64)
            T = torch.as_tensor(r["T"], device=dev)
            p = torch.as_tensor(r["p"], device=dev)
            X = r["state"].extent
            args = (T, p, c.ops.values_at_qp(T - 1.0), c.ops.values_at_qp(p),
                    X, 0.1)
            R = c.residual(*args)
            blocks = c.sys.element_jacobians(*args)
            btd = make_scan_block_solver(cfg, c.fes.element_dofs, c.n, c.ess,
                                         c.ess, c.fes.node_positions,
                                         device=dev)
            fac = btd.prepare(blocks)
            piece("residual", lambda: c.residual(*args), 5)
            piece("vmap(jacfwd) element Jacobians",
                  lambda: c.sys.element_jacobians(*args), 2)
            piece(f"{type(btd).__name__} factorization",
                  lambda: btd.prepare(blocks), 2)
            piece("banded solve with its GMRES",
                  lambda: btd.solve(fac, -R, rtol=1e-10), 2)
            piece("host splu (blocks to the host, assembly, factorization)",
                  lambda: c.host_lu(blocks), 2)
            lu = c.host_lu(blocks)
            piece("host LU solve (rhs to the host and back)",
                  lambda: lu.solve(-R), 3)
            piece("state advance", lambda: c.sys.advance_state_arrays(
                X, T, p, 0.1), 5)
            c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                      + ("newton", "total")}, 0.0)
            del c, blocks, fac, btd, lu, r
            torch.cuda.empty_cache()


def first_newton_system(device, tmp, ref_levels, label, nx=11, ny=239):
    """Case 1's first Newton system of step 1 on the graded strip (nx x ny
    quads, written to ``tmp`` once) refined ``ref_levels`` times, with the
    synthetic TACOT deck: (the ``Case1``, its element blocks, R)."""
    from .apps import ablation_case1
    from .core import make_strip_mesh_2d

    strip = os.path.join(tmp, f"strip{nx}x{ny}.msh")
    if not os.path.exists(strip):
        write_gmsh(make_strip_mesh_2d(nx, ny), strip)
    cfg = {"mesh_file": strip, "material_file": DECK, "order": 1,
           "dt": 0.1, "t_final": 0.1, "bdr_attr_top": 3, "probe_x": 0.00125,
           "newton_print_level": 0, "save_paraview": False,
           "serial_ref_levels": ref_levels,
           "output_path": os.path.join(tmp, f"c1_{label}")}
    c = ablation_case1.Case1(cfg, device, torch.float64)
    T, p = c.initial_fields()
    X = c.initial_state().extent
    To, po = c.ops.values_at_qp(T), c.ops.values_at_qp(p)
    T, p = c.enforce_bc(T, p, ablation_case1.evaluate_schedule(c.schedule,
                                                               c.dt))
    R = c.residual(T, p, To, po, X, c.dt)
    blocks = c.sys.element_jacobians(T, p, To, po, X, c.dt)
    return c, blocks, R


def profile_linemg(n, dev, rng, out, ref_levels=(0, 2)):
    """The first Newton system of the ablation case-1 step (chip_smoke
    phase 14a's two systems: the 11 x 239 strip, 5,760 DOFs, and refined
    twice, 86,130) through ``BlockNewtonKrylov`` GMRES(400) at rtol 1e-12,
    10 restart cycles at most, with ``pc="linemg"`` and ``pc="pointblock"``:
    inner iterations, set-up and solve (host clock, device synchronized),
    the true relative residual on the host matrix, and the direction
    against ``BlockTridiagDirect``'s, float64."""
    from .apps import ablation_case1
    from .solvers.blocksolve import (BlockNewtonKrylov, BlockTridiagDirect,
                                     strip_dof_lattice)

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        for lv in ref_levels:
            c, blocks, R = first_newton_system(dev, tmp, lv, f"lmg{lv}")
            b = -R
            lat = strip_dof_lattice(c.fes.node_positions)
            ed = c.fes.element_dofs
            btd = BlockTridiagDirect(ed, c.n, c.ess, c.ess, dof_lattice=lat,
                                     device=dev)
            d_dir = btd.solve(btd.prepare(blocks), b, rtol=1e-12).x
            A = c.host_matrix(blocks)
            b_np = b.cpu().numpy()
            for pc in ("linemg", "pointblock"):
                bks = BlockNewtonKrylov(ed, c.n, c.ess, c.ess, restart=400,
                                        maxiter=10, dof_lattice=lat, pc=pc,
                                        device=dev)
                fac, setup_s = timed(lambda: bks.prepare(blocks))
                res, solve_s = timed(lambda: bks.solve(fac, b, rtol=1e-12))
                tr = float(np.linalg.norm(A @ res.x.cpu().numpy() - b_np)
                           / np.linalg.norm(b_np))
                d = float(torch.linalg.vector_norm(res.x - d_dir)
                          / torch.linalg.vector_norm(d_dir))
                out(f"== ablation_case1 first Newton system, {2 * c.n} DOFs "
                    f"(strip refined {lv}x), pc={pc}: {res.inner_iters} "
                    f"inner iterations ({res.iters} cycles, converged flag "
                    f"{res.converged}), set-up {1e3 * setup_s:.1f} ms, "
                    f"solve {solve_s:.3f} s, true rel residual {tr:.3e}, "
                    f"direction vs BlockTridiagDirect {d:.3e}")
                del bks, fac
            c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                      + ("newton", "total")}, 0.0)
            del c, blocks, R, A, btd
            torch.cuda.empty_cache()


def profile_linemg_levels(n, dev, rng, out, ref_levels=(0, 2, 3)):
    """``line_factor`` and ``line_solve`` at every level of the line-MG
    hierarchy of the first Newton system on the strip refined
    ``ref_levels`` times: device ms per call and ms per call beside the
    bound (``kernels.linemg.level_times``), float64."""
    from .apps import ablation_case1
    from .kernels import linemg as klmg
    from .solvers.blocksolve import BlockNewtonKrylov, strip_dof_lattice

    with tempfile.TemporaryDirectory() as tmp:
        for lv in ref_levels:
            c, blocks, _ = first_newton_system(dev, tmp, lv, f"lvl{lv}")
            bks = BlockNewtonKrylov(
                c.fes.element_dofs, c.n, c.ess, c.ess,
                dof_lattice=strip_dof_lattice(c.fes.node_positions),
                pc="linemg", device=dev)
            hierarchy = bks.prepare(blocks)[1]
            for level, (SS, fac) in enumerate(hierarchy):
                NY, NX = SS.shape[2], SS.shape[3]
                r = torch.as_tensor(rng.standard_normal((NY, NX, 2)),
                                    device=dev)
                out(f"== line-MG level {level} of {len(hierarchy)}, "
                    f"{2 * c.n} DOFs (strip refined {lv}x), NY={NY}, "
                    f"NX={NX}, float64: "
                    + klmg.describe(klmg.level_times(SS, fac, r)))
            c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                      + ("newton", "total")}, 0.0)
            del c, blocks, bks, hierarchy
            torch.cuda.empty_cache()


def profile_linemg_tall(n, dev, rng, out,
                        shapes=((4097, 1), (7649, 1), (7649, 353))):
    """``line_factor`` and ``line_solve`` on seeded, block-diagonally
    dominant line systems (fields of scale 1 and 1e-3) as tall as the
    strip refined 5 times (NY = 7,649; its finest NX 353, and NX = 1),
    where the solve's runs reach past shared memory in float64, and at NY
    = 4,097, the most it holds: the launch geometry, device ms and ms a
    call beside the bound (``kernels.linemg.level_times``) and the line
    residual |A_line x - r| / |r|, float64."""
    from .kernels import linemg as klmg
    from .solvers.linemg import line_residual

    gen = torch.Generator(device=dev).manual_seed(5)
    for NY, NX in shapes:
        SS = torch.zeros((3, 3, NY, NX, 2, 2), dtype=torch.float64,
                         device=dev)
        scale = torch.tensor([1.0, 1e-3], dtype=torch.float64,
                             device=dev)[:, None]
        eye = torch.eye(2, dtype=torch.float64, device=dev)
        for oy, diag in ((0, -1.0), (1, 4.0), (2, -1.0)):
            SS[oy, 1] = (diag * eye + 0.3 * torch.randn(
                (NY, NX, 2, 2), generator=gen, dtype=torch.float64,
                device=dev)) * scale
        r = torch.randn((NY, NX, 2), generator=gen, dtype=torch.float64,
                        device=dev)
        fac = klmg.line_factor(SS)
        res = line_residual(SS, klmg.line_solve(fac, r), r)
        out(f"== line kernels at NY={NY}, NX={NX}, float64, geometry "
            f"{klmg.kernel_solve_geometry(NY, NX, 8)}: line residual "
            f"{res:.3e}; " + klmg.describe(klmg.level_times(SS, fac, r)))
        del SS, fac, r
        torch.cuda.empty_cache()


def profile_ablation_case21(n, dev, rng, out, nx=11, ny=239):
    """One step of the ablation case-2.1 driver on chip_smoke's phase-12
    strip (11 x 239 quads, 5,760 DOFs) with the synthetic deck, B' table
    and schedule, float64, through the eager host-LU path and through
    ``scan_stepping``: the driver run whole for 1 and for 2 steps under the
    profiler, differenced (device busy and idle share of step 2); then each
    piece alone at the scan run's final state (host ms with the device
    synchronized, and device busy): the domain residual, the SEB face
    residual and the B' lookup inside it, the element Jacobians, the face
    Jacobians, the host ``splu`` with the face blocks, the block-QR
    factorization, the banded solve and one diagnostics row."""
    from .apps import ablation_case2_1
    from .core import make_strip_mesh_2d
    from .solvers.blocksolve import make_scan_block_solver

    sched = os.path.join(os.path.dirname(DECK), "surface_bc_case21.dat")

    def piece(label, fn, reps, top=5):
        ms = host_ms(fn, reps=reps, warmup=1)
        profiled(label, fn, reps, out, top=top)
        out(f"   {label}: unprofiled {ms:.3f} ms per call (host clock, "
            "device synchronized)")

    with tempfile.TemporaryDirectory() as tmp:
        strip = write_gmsh(make_strip_mesh_2d(nx, ny),
                           os.path.join(tmp, "strip.msh"))
        cfg = {"mesh_file": strip, "material_file": DECK,
               "boundary_conditions_file": sched, "order": 1, "dt": 0.1,
               "bdr_attr_top": 3, "probe_x": 0.00125,
               "newton_print_level": 0, "save_paraview": False,
               "output_path": os.path.join(tmp, "out")}
        run = lambda steps, scan: ablation_case2_1.run(
            {**cfg, "t_final": steps * 0.1, "scan_stepping": scan},
            device=dev)
        run(1, False)  # warm: the AD transforms' first use, the allocator
        for scan in (False, True):
            w1, b1, _ = device_busy(lambda: run(1, scan))
            w2, b2, r = device_busy(lambda: run(2, scan))
            wall, busy = w2 - w1, b2 - b1
            out(f"== ablation_case2_1 "
                f"{'scan_stepping' if scan else 'eager host LU'}, "
                f"{2 * r['fes'].nscalar} DOFs, step 2 (chemistry_blowing): "
                f"wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
                f"{1 - busy / wall:.3f}; {r['newton_iters'][1]} Newton "
                f"solves; the driver's own clock, ms: "
                + ", ".join(f"{k} {1e3 * v:.1f}"
                            for k, v in r["timing"][1].items()))
        c = ablation_case2_1.Case21({**cfg, "t_final": 0.1}, dev,
                                    torch.float64)
        T = torch.as_tensor(r["T"], device=dev)
        p = torch.as_tensor(r["p"], device=dev)
        X = r["state"].extent
        bc, branch = c.boundary(0.3)
        seb = c.seb(branch)
        args = (T, p, c.ops.values_at_qp(T - 1.0), c.ops.values_at_qp(p), X,
                0.1)
        tr = c.sys.trace
        Tw = tr.values(T)
        bg = torch.full_like(Tw, 3e-3)
        pw = torch.full_like(Tw, bc.p_w)
        blocks = c.sys.element_jacobians(*args)
        face = c.face_jacobians(T, p, X, bc, branch)
        btd = make_scan_block_solver(cfg, c.fes.element_dofs, c.n, c.ess_T,
                                     c.ess, c.fes.node_positions, device=dev)
        fac = btd.prepare(blocks, face=face, face_elem=tr.elem)
        R = c.residual(*args, bc, branch)
        piece("domain residual", lambda: c.sys.residual(*args), 5)
        piece("SEB face residual",
              lambda: c.sys.seb_face_residual(T, p, X, bc, *seb), 5)
        piece(f"B' lookup at the {tuple(Tw.shape)} face QPs",
              lambda: c.bprime.lookup(pw, bg, Tw), 5)
        piece("vmap(jacfwd) element Jacobians",
              lambda: c.sys.element_jacobians(*args), 2)
        piece("vmap(jacfwd) SEB face Jacobians",
              lambda: c.face_jacobians(T, p, X, bc, branch), 3)
        piece("host splu with the face blocks",
              lambda: c.host_lu(blocks, face=face), 2)
        piece(f"{type(btd).__name__} factorization with the face blocks",
              lambda: btd.prepare(blocks, face=face, face_elem=tr.elem), 2)
        piece("banded solve with its GMRES",
              lambda: btd.solve(fac, -R, rtol=1e-10), 2)
        piece("diagnostics row (read back)",
              lambda: c.boundary_values(T, p, X, bc, branch).cpu(), 5)
        c.finish({k: 0.0 for k in ablation_case2_1.TIMING_KEYS
                  + ("newton", "total")}, 0.0)


def case22_pieces(cfg, r, dev):
    """The pieces of a case-2.2 step at a run's final state (``r``: a
    ``run`` result on ``cfg``'s strip), with the chemistry-blowing boundary
    of t = 0.3 so that the surface recedes: {label: fn} for the recession
    velocity, the smoothing CG started cold and warm (from the smoothed
    field of 0.9 v), the device remap, the quality metric with the
    geometric factors, the residual, the element and face Jacobians, the
    block-QR factorization, the banded solve and one step's diagnostics
    read back.  Returns (pieces, case): ``case.finish`` closes its CSVs."""
    from .apps import ablation_case2_2
    from .solvers.blocksolve import make_scan_block_solver

    c = ablation_case2_2.Case22(
        {**cfg, "t_final": 0.1, "scan_stepping": False,
         "output_path": os.path.join(cfg["output_path"] + "_pieces")}, dev,
        torch.float64)
    m = ablation_case2_2.ScanMotion(c, 1)
    ops = c.ops
    tens = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    T, p, verts = tens(r["T"]), tens(r["p"]), tens(r["vertices"])
    X = r["state"].extent.to(dev)
    bc, branch = c.boundary(0.3)
    dt = 0.1
    v_rec, mean_v = m.velocity(T, p, X, bc, branch, verts)
    wy_prev = m.smoother.solve(verts, 0.9 * v_rec).x
    Xn, _, _, wy, wq, _, J_pre = m.move(X, verts, mean_v * 0, wy_prev,
                                        v_rec, mean_v, dt)
    gf = ops.geometric_factors(verts)
    g = c.geometry(verts, wq, J_pre)
    To, po = ops.values_at_qp(T - 1.0), ops.values_at_qp(p)
    args = (To, po, X, dt, bc, branch, g)
    blocks, face = c.jacobians(T, p, *args)
    bks = make_scan_block_solver(c.cfg, c.fes.element_dofs, c.n, c.ess_T,
                                 c.ess, c.fes.node_positions, device=dev)
    tr = c.sys.trace
    fac = bks.prepare(blocks, face=face, face_elem=tr.elem)
    R = c.residual(T, p, *args)
    arrays = c.sys.advance_state_arrays(X, T, p, dt)
    pieces = {
        "recession velocity": lambda: m.velocity(T, p, X, bc, branch, verts),
        "smoothing CG, cold start": lambda: m.smoother.solve(verts, v_rec),
        "smoothing CG, warm start": lambda: m.smoother.solve(
            verts, v_rec, x0=wy_prev),
        "device remap": lambda: m.remap(X, verts, gf.xq, wq, dt),
        "quality metric + geometric factors": lambda: (
            m.min_quality(verts), ops.geometric_factors(verts).detJ),
        "residual (domain + SEB face)": lambda: c.residual(T, p, *args),
        "vmap(jacfwd) element Jacobians": lambda: c.sys.element_jacobians(
            T, p, To, po, X, dt, gf=g.gf, wq=g.wq, gcl=g.gcl,
            ale_toggles=c.ale_toggles),
        "vmap(jacfwd) SEB face Jacobians": lambda: c.sys.seb_face_jacobians(
            T, p, X, bc, *c.seb(branch), vertices=verts),
        f"{type(bks).__name__} factorization": lambda: bks.prepare(
            blocks, face=face, face_elem=tr.elem),
        "banded solve": lambda: bks.solve(fac, -R, rtol=1e-10),
        "diagnostics of one step, read back": lambda: [
            x.cpu() for x in m.step_diagnostics(T, p, X, arrays[6],
                                                arrays[1], verts, bc,
                                                branch)],
    }
    del Xn, wy
    return pieces, c


def profile_ablation_case22(n, dev, rng, out, nx=11, ny=239):
    """One step of the ablation case-2.2 driver on chip_smoke's phase-13
    strip (11 x 239 cells split into 5,258 triangles, 5,760 DOFs) with the
    synthetic deck, B' table and schedule, float64, through the eager
    host-LU path and through ``scan_stepping``: the driver run whole for 1
    and for 2 steps under the profiler, differenced (device busy and idle
    share of step 2, which recedes); then each piece alone
    (``case22_pieces``: host ms with the device synchronized, and device
    busy)."""
    from .apps import ablation_case2_2
    from .core import make_strip_mesh_2d

    sched = os.path.join(os.path.dirname(DECK), "surface_bc_case21.dat")
    with tempfile.TemporaryDirectory() as tmp:
        strip = write_gmsh(make_strip_mesh_2d(nx, ny, geom="triangle"),
                           os.path.join(tmp, "strip.msh"))
        cfg = {"mesh_file": strip, "material_file": DECK,
               "boundary_conditions_file": sched, "order": 1, "dt": 0.1,
               "bdr_attr_top": 3, "bdr_attr_bottom": 1, "probe_x": 0.00125,
               "newton_print_level": 0, "save_paraview": False,
               "output_path": os.path.join(tmp, "out")}
        run = lambda steps, scan: ablation_case2_2.run(
            {**cfg, "t_final": steps * 0.1, "scan_stepping": scan},
            device=dev)
        run(1, False)  # warm: the AD transforms' first use, the allocator
        for scan in (False, True):
            w1, b1, _ = device_busy(lambda: run(1, scan))
            w2, b2, r = device_busy(lambda: run(2, scan))
            wall, busy = w2 - w1, b2 - b1
            out(f"== ablation_case2_2 "
                f"{'scan_stepping' if scan else 'eager host LU'}, "
                f"{2 * r['fes'].nscalar} DOFs, step 2 (chemistry_blowing, "
                f"moved {r['moved'][1]}): wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}; "
                f"{r['newton_iters'][1]} Newton solves; the driver's own "
                "clock, ms: " + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in
                                         r["timing"][1].items()))
        pieces, c = case22_pieces(cfg, r, dev)
        for label, fn in pieces.items():
            ms = host_ms(fn, reps=3, warmup=1)
            profiled(label, fn, 3, out, top=5)
            out(f"   {label}: unprofiled {ms:.3f} ms per call (host clock, "
                "device synchronized)")
        c.finish({k: 0.0 for k in ablation_case2_2.TIMING_KEYS
                  + ("newton", "total")}, 0.0)


SECTIONS = {"operators": profile_operators, "vcycle": profile_vcycle,
            "zchain": profile_zchain, "driver": profile_driver,
            "nonlinear": profile_nonlinear,
            "elasticity_cg": profile_elasticity_cg,
            "ablation": profile_ablation, "linemg": profile_linemg,
            "linemg_levels": profile_linemg_levels,
            "linemg_tall": profile_linemg_tall,
            "ablation_case21": profile_ablation_case21,
            "ablation_case22": profile_ablation_case22}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of: " + ", ".join(SECTIONS))
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args(argv)
    dev = require_cuda()
    # the report goes to --out line by line, so a run cut by a time limit
    # keeps what it measured
    sink = open(args.out, "w") if args.out else None

    def out(s):
        print(s, flush=True)
        if sink is not None:
            sink.write(s + "\n")
            sink.flush()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(0)
    try:
        for name in args.sections.split(","):
            SECTIONS[name](args.n, dev, rng, out)
    finally:
        if sink is not None:
            sink.close()


if __name__ == "__main__":
    main()
