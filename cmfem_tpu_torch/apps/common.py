"""Shared app-driver scaffolding: CLI, device choice, mesh setup, config echo.

Port of ``cmfem_tpu/apps/common.py``.  Each app mirrors one reference driver: parse
`-i input.yaml`, echo config, build mesh/space, run, write CSV + ParaView.
A driver's ``run(cfg, device=None)`` runs on the CUDA device and raises
without one; ``device="cpu"``, or ``CMFEM_FORCE_CPU=1`` for ``main()``,
asks for the CPU.  The drivers default to float64 (native on the GPU), so
the decks' tolerances (``solver_rtol: 1e-12``) are reachable; the
float32-floor acceptance of ``check_standalone_linear`` stays for a caller
who passes ``dtype=torch.float32``."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import require_cuda
from ..core import load_gmsh, Mesh
from ..io import writes_files
from ..utils.timing import host_sync
from ..utils.yamlcfg import resolve_path


def parse_args(default_input: str, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", default=default_input, help="YAML input file.")
    return ap.parse_args(argv)


def resolve_device(device=None) -> torch.device:
    """The device a driver runs on: the CUDA device when none is named
    (RuntimeError without one), else the one asked for."""
    return require_cuda() if device is None else torch.device(device)


def device_from_env():
    """``main()``'s device argument: "cpu" when CMFEM_FORCE_CPU=1, else None
    (the CUDA device)."""
    return "cpu" if os.environ.get("CMFEM_FORCE_CPU", "0") == "1" else None


def load_mesh_from_cfg(cfg: dict, expected_dim: int = 2) -> Mesh:
    mesh_file = cfg.get("mesh_file")
    if not mesh_file:
        raise KeyError("Missing required YAML key: mesh_file")
    mesh = load_gmsh(resolve_path(cfg, mesh_file))
    if mesh.dim != expected_dim:
        raise ValueError(f"The mesh must be {expected_dim}D.")
    levels = int(cfg.get("serial_ref_levels", 0)) + int(cfg.get("par_ref_levels", 0))
    if levels:
        mesh = mesh.uniform_refine(levels)
    return mesh


def make_mg_preconditioner(cfg, order, make_form, ess_dofs=None, *, device,
                           dtype=torch.float64):
    """Geometric-multigrid preconditioner for a driver's linear solves
    (``linear_solver: mg`` in diffusion_mms, linear_cd_2d and
    linear_cd_transient; the reference's petsc*.opts PC-configuration
    analog).

    Re-derives the driver's own refinement chain from the cfg
    (serial_ref_levels + par_ref_levels), p-coarsens order>1 to 1 on
    the finest mesh, then h-coarsens down the chain.  ``make_form``
    builds the level bilinear form from a level SpaceOps on ``device`` in
    ``dtype``."""
    from ..solvers import GeometricMG

    base = load_mesh_from_cfg(
        {**cfg, "serial_ref_levels": 0, "par_ref_levels": 0})
    nref = int(cfg.get("serial_ref_levels", 0)) \
        + int(cfg.get("par_ref_levels", 0))
    if nref < 1 and order < 2:
        raise ValueError(
            "linear_solver: mg needs a hierarchy — set "
            "serial_ref_levels >= 1 and/or order >= 2")
    chain = [base]
    for _ in range(nref):
        chain.insert(0, chain[0].uniform_refine(1))
    specs = [(chain[0], order)]
    if order > 1:
        specs.append((chain[0], 1))
    specs += [(m, 1) for m in chain[1:]]
    mg = GeometricMG.build(specs, make_form, ess_dofs=ess_dofs,
                           device=device, dtype=dtype)
    Mmg, mg_arrays = mg.bind()
    print(f"MG hierarchy: {len(specs)} levels "
          f"({[s[0].num_elements for s in specs]} elems at orders "
          f"{[s[1] for s in specs]})")
    return lambda r: Mmg(r, mg_arrays)


def echo_config(cfg_obj, title="Loaded configuration:"):
    print(title)
    for k, v in cfg_obj.items() if isinstance(cfg_obj, dict) else vars(cfg_obj).items():
        if k.startswith("_"):
            continue
        print(f"  {k}: {v}")


def ensure_outdir(path: str):
    """Create the output directory (on a rank that writes files:
    ``io.output``)."""
    if writes_files():
        os.makedirs(path, exist_ok=True)
    return path


def validate_unit_square(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    if not (abs(lo[0]) <= tol and abs(hi[0] - 1) <= tol
            and abs(lo[1]) <= tol and abs(hi[1] - 1) <= tol):
        raise ValueError(
            f"Mesh coordinates must span approximately [0,1]x[0,1]. "
            f"Got x=[{lo[0]},{hi[0]}], y=[{lo[1]},{hi[1]}]."
        )


def validate_unit_circle(mesh: Mesh, tol=1e-6):
    r = np.linalg.norm(mesh.vertices, axis=1).max()
    if abs(r - 1.0) > tol:
        raise ValueError(f"Expected unit-circle mesh (max radius near 1). "
                         f"Found max radius {r}.")


def validate_square(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    lx, ly = hi[0] - lo[0], hi[1] - lo[1]
    scale = max(abs(lx), abs(ly), 1.0)
    if lx <= tol or ly <= tol or abs(lx - ly) > 1e-8 * scale + tol:
        raise ValueError(f"Mesh must be square (equal x/y extents). "
                         f"Got lx={lx}, ly={ly}.")


def x_boundary_attrs(mesh: Mesh, tol=1e-8):
    """Attributes of boundary faces lying on the x-extremes (the transient
    driver's geometric Dirichlet detection)."""
    lo, hi = mesh.bounding_box()
    centers = mesh.vertices[mesh.bdr_conn].mean(axis=1)
    on_x = (np.abs(centers[:, 0] - lo[0]) <= tol) | (np.abs(centers[:, 0] - hi[0]) <= tol)
    return sorted(set(mesh.bdr_attr[on_x].tolist()))


def y_boundary_attrs(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    centers = mesh.vertices[mesh.bdr_conn].mean(axis=1)
    on_y = (np.abs(centers[:, 1] - lo[1]) <= tol) | (np.abs(centers[:, 1] - hi[1]) <= tol)
    return sorted(set(mesh.bdr_attr[on_y].tolist()))


def num_steps(t_final: float, dt: float) -> int:
    """ceil(t_final/dt - 1e-12), as in the reference drivers."""
    import math

    return int(math.ceil(t_final / dt - 1.0e-12))


_lin_warnings = {"count": 0}

# Inexact-Newton forcing: a Krylov direction whose PRECONDITIONED
# relative residual is below eta reduces the linearized residual by
# that factor, which is all an outer Newton step needs (Eisenstat &
# Walker: any eta < 1 preserves local convergence; 1e-2 keeps it
# near-quadratic).  Used to arbitrate solves that hit the cycle cap
# while still progressing — the float32 regime where the deck's f64
# rtol is clamped to the 16 eps floor and GMRES may grind toward it
# at >10%/cycle without arriving within gmres_maxiter cycles.
LINEAR_FORCING_ETA = 1.0e-2

# Acceptance bound for STANDALONE stagnated solves: a linear driver with
# no outer Newton arbiter may accept a stagnation-window exit only when
# the achieved true relative residual is below this floor — loose enough
# for the f32 precision floor (~100s of eps after conditioning), tight
# enough that a defeated preconditioner stalling at rel ~1e-1 raises
# instead of silently producing wrong error metrics.
STAGNATION_ACCEPT_REL = 1.0e-3


def linear_usable(sol, eta: float = LINEAR_FORCING_ETA):
    """Is this SolveResult a Newton-usable direction?
    converged | stagnated-at-floor | inexact-Newton forcing met."""
    rel = getattr(sol, "rel_residual", -1.0)
    return (sol.converged | getattr(sol, "stagnated", False)
            | ((rel >= 0) & (rel < eta)))


def check_linear_result(res, what: str):
    """Arbitrate an iterative linear SolveResult inside a Newton loop.

    converged -> fine.  stagnated (a full GMRES cycle improved the true
    residual <10% — the working-precision floor in float32, or a
    defeated preconditioner) or cycle-cap-with-forcing-met (preconditioned
    rel residual < LINEAR_FORCING_ETA, an exact-enough inexact-Newton
    direction) -> accept the iterate with a rate-limited warning; the
    OUTER Newton convergence check is the arbiter of whether the solve
    was good enough (reference analog: MUMPS LU never reports failure
    either; its KSP check exists to catch silent Krylov failure, which
    Newton's own residual test subsumes here).  Neither -> fail fast with the tuning hint."""
    if bool(res.converged):
        return
    rel = float(getattr(res, "rel_residual", -1.0))
    if bool(getattr(res, "stagnated", False)) or 0 <= rel < LINEAR_FORCING_ETA:
        _lin_warnings["count"] += 1
        if _lin_warnings["count"] <= 3:
            print(f"WARNING: {what} stopped above tol at residual "
                  f"{float(res.residual):.3e} (rel {rel:.1e}) after "
                  f"{int(res.iters)} cycles (working-precision floor or "
                  "cycle cap with forcing met); Newton's residual test "
                  "arbitrates.")
        return
    raise RuntimeError(
        f"{what} did not converge: residual {float(res.residual):.3e} "
        f"after {int(res.iters)} restart cycles "
        "(raise gmres_restart/gmres_maxiter)")


def check_standalone_linear(res, what="Linear solver"):
    """Fail-fast convergence check for the standalone (non-Newton) linear
    drivers (reference analog: the PETSc KSP verification).  ``converged``
    passes.
    ``stagnated`` — a full Krylov cycle improved the TRUE residual by
    <10%, i.e. the iteration sits on the working-precision floor of the
    arithmetic — also passes, with a warning: the reference decks carry
    f64 tolerances (rtol 1e-10..1e-12) that are unreachable in float32,
    where the floored iterate IS the converged answer to
    working precision.  Anything else (cycle cap while still progressing)
    raises with the tuning hint."""
    if bool(res.converged):
        return
    rel = float(getattr(res, "rel_residual", -1.0))
    if bool(getattr(res, "stagnated", False)):
        # a stagnated iterate is only acceptable if it actually SOLVED
        # the system to within a loose precision-floor bound: plain slow
        # convergence (a defeated preconditioner stalling at rel ~1e-1)
        # also trips the stagnation window, and silently accepting it
        # hands the driver a wrong solution
        if 0.0 <= rel <= STAGNATION_ACCEPT_REL:
            print(f"WARNING: {what} stopped at the working-precision "
                  f"floor: residual {float(res.residual):.3e} "
                  f"(rel {rel:.1e}) after {int(res.iters)} iterations "
                  "(deck rtol targets the f64 regime).")
            return
        raise RuntimeError(
            f"{what} stagnated ABOVE the acceptance floor: rel residual "
            f"{rel:.3e} > {STAGNATION_ACCEPT_REL:.1e} after "
            f"{int(res.iters)} iterations — the preconditioner is "
            "defeated or the system is inconsistent; this is not a "
            "working-precision floor (improve the preconditioner or "
            "raise solver_maxiter)")
    raise RuntimeError(
        f"{what} did not converge. Iterations={int(res.iters)}, "
        f"residual={float(res.residual)} "
        "(raise solver_maxiter/solver_restart)")


def load_newton_config(cfg: dict, *, abs_tol=1e-8, rel_tol=1e-6,
                       max_iter=20):
    """NewtonConfig from the reference YAML keys plus the
    working-precision stall-exit knobs (newton_stall_improve /
    newton_stall_patience / newton_stall_accept_rel; see
    solvers.newton.NewtonConfig — newton_stall_accept_rel: 0 disables)."""
    from ..solvers.newton import NewtonConfig

    return NewtonConfig(
        abs_tol=float(cfg.get("newton_abs_tol", abs_tol)),
        rel_tol=float(cfg.get("newton_rel_tol", rel_tol)),
        max_iter=int(cfg.get("newton_max_iter", max_iter)),
        stall_improve=float(cfg.get("newton_stall_improve", 1e-3)),
        stall_patience=int(cfg.get("newton_stall_patience", 2)),
        stall_accept_rel=float(cfg.get("newton_stall_accept_rel", 1e-3)),
        stall_dx_rtol=cfg.get("newton_stall_dx_rtol", None),
        stall_flat_factor=float(cfg.get("newton_stall_flat_factor", 1.15)),
    )


# -- the ablation half: Newton loops and the block linear solvers -----------

def device_sync(device):
    """A callable that waits for ``device`` (nothing on the CPU), for
    ``StepTimer(sync=...)`` and the Newton loop's update timing."""
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def scan_newton(T, p, *, residual, solve, config):
    """The device-resident Newton loop of the ablation scan paths (the
    JAX package's ``lax.while_loop``, here a host loop over device tensors
    that reads back one scalar per iteration: whether it is done).

    ``residual(T, p) -> R`` (BC-masked stacked residual) and
    ``solve(T, p, R) -> (T_new, p_new, |dx|, lin_ok)`` close over the
    step's frozen inputs; ``config`` is the ``NewtonConfig``
    (``load_newton_config``).  Reference semantics — r0 = max(1, |R0|),
    abs/rel tolerance, at most ``max_iter`` residual checks/solves — plus
    the working-precision stall exits of ``NewtonConfig`` as tensors, so
    that no exit test syncs (``solvers.newton.StallWindow`` keeps them on
    host floats for the eager loops; patience
    ``stall_patience`` non-improving residuals, then any of: rn/r0 <
    stall_accept_rel; |dx| <= stall_dx_rtol |[T;p]| (default 30 eps); the
    residual flat within ``stall_flat_factor`` of its best over the window
    with every linear solve usable).  A diverging solve never stall-exits:
    it runs to max_iter and reports done=False.

    Returns (T, p, iters, r0, rn, done, res_history, update_history,
    linear_ok, stalled) with NaN-padded (max_iter + 1,) device histories for
    the newton CSV replay; ``iters`` counts residual checks (one more than
    the linear solves when done)."""
    dev, dtype = T.device, T.dtype
    c, max_iter = config, config.max_iter
    stall_dx_rtol = c.stall_dx_rtol
    if stall_dx_rtol is None:
        stall_dx_rtol = 30.0 * float(torch.finfo(dtype).eps)
    flat_enabled = float(c.stall_flat_factor) > 1.0
    scal = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    res_h = torch.full((max_iter + 1,), float("nan"), dtype=dtype, device=dev)
    upd_h = res_h.clone()
    inf = float("inf")
    host_sync(5)   # the five numbers below, copied to the device
    r0, rn, rbest, rmax, un_prev = scal(1.0), scal(inf), scal(inf), \
        scal(inf), scal(inf)
    noimp = torch.zeros((), dtype=torch.int64, device=dev)
    was_stalled = torch.zeros((), dtype=torch.bool, device=dev)
    lin_ok = True
    done = False
    it = 0
    while it < max_iter:
        R = residual(T, p)
        rn = torch.linalg.vector_norm(R)
        if it == 0:
            r0 = torch.clamp(rn, min=1.0)
        rbest_pre = rbest
        improved = rn < (1.0 - c.stall_improve) * rbest
        noimp = torch.where(improved, 0, noimp + 1)
        # max residual over the current non-improving window
        rmax = torch.where(improved, rn, torch.maximum(rmax, rn))
        rbest = torch.minimum(rbest, rn)
        xnorm = torch.sqrt(torch.sum(T * T) + torch.sum(p * p))
        flat_ok = (rmax <= c.stall_flat_factor * rbest_pre) & lin_ok \
            if flat_enabled else False
        stalled = (noimp >= c.stall_patience) & (
            (rn / r0 < c.stall_accept_rel)
            | (un_prev <= stall_dx_rtol * xnorm) | flat_ok)
        tol_done = (rn < c.abs_tol) | (rn / r0 < c.rel_tol)
        was_stalled = was_stalled | (stalled & ~tol_done)
        res_h[it] = rn
        it += 1
        host_sync()
        if bool(tol_done | stalled):
            done = True
            break
        T, p, un, ok = solve(T, p, R)
        upd_h[it - 1] = un
        lin_ok = lin_ok and bool(ok)
        un_prev = un
    return T, p, it, r0, rn, done, res_h, upd_h, lin_ok, was_stalled


def replay_newton_history(newton_csv, gstep, tk, nit, r0k, res_h, upd_h):
    """Replay one scan step's recorded Newton iterate history into the
    newton CSV (NaN marks unused history slots)."""
    du0 = max(1.0, float(upd_h[0])) if np.isfinite(upd_h[0]) else 1.0
    for i in range(nit + 1):
        rk = res_h[i]
        if not np.isfinite(rk):
            break
        uk = upd_h[i]
        conv = 1 if (i == nit or not np.isfinite(uk)) else 0
        un = 0.0 if not np.isfinite(uk) else float(uk)
        newton_csv.writerow([gstep, tk, i, float(rk), r0k,
                             float(rk) / r0k, un, du0, un / du0, conv])


class NewtonStallStats:
    """Accumulates per-step Newton stall-exit statistics: how many steps
    were accepted at the working-precision stall floor rather than the
    abs/rel tolerance, and the distribution of those steps' final relative
    residuals."""

    def __init__(self):
        self.steps = 0
        self.stalled = 0
        self._rels = []

    def update(self, nw_stalls, rns, r0s):
        m = np.asarray(nw_stalls, dtype=bool)
        self.steps += int(m.size)
        self.stalled += int(m.sum())
        if m.any():
            rel = np.asarray(rns, dtype=float)[m] \
                / np.maximum(np.asarray(r0s, dtype=float)[m], 1e-300)
            self._rels.extend(rel.tolist())

    def summary(self):
        out = {"newton_steps": self.steps,
               "newton_stalled_steps": self.stalled,
               "newton_stalled_frac": round(
                   self.stalled / max(1, self.steps), 5)}
        if self._rels:
            r = np.asarray(self._rels)
            out["stalled_rel_residual"] = {
                "min": float(r.min()),
                "p50": float(np.percentile(r, 50)),
                "p90": float(np.percentile(r, 90)),
                "max": float(r.max())}
        return out


def run_tp_newton_loop(T, p, *, residual, factorize, enforce_bc,
                       newton_cfg, rebuild_freq, newton_csv, step, t, n,
                       timer, print_level=0, print_multiline=True):
    """The Newton loop of the ablation drivers (PetscNewtonSolver::SolveImpl
    semantics: r0 = max(1, |R0|), abs/rel tolerance, Jacobian rebuild
    frequency, BC re-enforcement after every update, per-iteration CSV
    logging, and the stall exits of ``scan_newton``).

    residual(T, p) -> R (2n,) BC-masked stacked residual;
    factorize(T, p) -> object with .solve(rhs) -> dx, a tensor on rhs's
    device (host LU or on-device block GMRES — see
    make_block_linear_solver); enforce_bc(T, p) -> (T, p).

    Newton CSV row schema:
    [step, t, it, |R|, r0, |R|/r0, |du|, du0, |du|/du0, converged].

    The residual check, the linear solve and the update are the spans
    ``residual``, ``linear`` and ``update`` of ``timer``, the driver's
    ``StepTimer``: no sync of their own, and ranges of the profiler's trace
    when one records.

    Returns (T, p, iters, timing) with timing keys nres/njac/nlin/nupd;
    raises RuntimeError on non-convergence."""
    import time as _time

    from ..solvers.newton import StallWindow

    spans = timer.spans
    nres = njac = nlin = nupd = 0.0
    r0 = du0 = 1.0
    converged = False
    iters = 0
    final_res = np.inf
    lu = None
    window = StallWindow(newton_cfg, T.dtype)
    for it in range(newton_cfg.max_iter):
        with timer.span("residual"):
            R = residual(T, p)
            host_sync()
            res_norm = float(torch.linalg.vector_norm(R))
        nres += spans["residual"]
        if it == 0:
            r0 = max(1.0, res_norm)
        rel_res = res_norm / r0
        final_res = res_norm
        # every linear solve here passed check_linear_result, satisfying
        # the flat exit's usable-solve gate
        host_sync()
        stalled = window.update(res_norm, rel_res, float(
            torch.sqrt(torch.sum(T * T) + torch.sum(p * p))))
        if res_norm < newton_cfg.abs_tol or rel_res < newton_cfg.rel_tol \
                or stalled:
            converged = True
            iters = it
            newton_csv.writerow([step, t, it, res_norm, r0, rel_res,
                                 0.0, du0, 0.0, 1])
            break
        if lu is None or it % rebuild_freq == 0:
            tt = _time.perf_counter()
            lu = factorize(T, p)
            njac += _time.perf_counter() - tt
        with timer.span("linear"):
            dx = lu.solve(-R)
            host_sync()
            un = float(torch.linalg.vector_norm(dx))
        nlin += spans["linear"]
        with timer.span("update"):
            window.un_prev = un
            if it == 0:
                du0 = max(1.0, un)
            T, p = enforce_bc(T + dx[:n], p + dx[n:])
            host_sync()
            device_sync(T.device)()
        nupd += spans["update"]
        newton_csv.writerow([step, t, it, res_norm, r0, rel_res,
                             un, du0, un / du0, 0])
        if print_level > 0:
            if print_multiline:
                print(f"NR iteration {it}:\n|R|/|R0|= {rel_res}\n"
                      f"|R|= {res_norm}\n|du|/|du0|= {un / du0}\n|du|= {un}")
            else:
                print(f"NR iteration {it}: |R|/|R0|= {rel_res} "
                      f"|R|= {res_norm}")
    if not converged:
        raise RuntimeError(
            f"Newton did not converge at step {step}, final residual="
            f"{final_res}")
    return T, p, iters, {"nres": nres, "njac": njac, "nlin": nlin,
                         "nupd": nupd}


def make_block_linear_solver(cfg: dict, element_dofs, n, ess_T, ess_p,
                             node_positions=None, *, device):
    """Optional on-device iterative solver for the ablation (T, p) Newton
    systems (YAML key ``linear_solver``).

    Returns None for the default host sparse-LU path (``lu``, the MUMPS
    analog), or a factory ``factory(blocks, face=None, face_elem=None)``
    producing objects whose ``.solve(rhs)`` returns dx on the device, so the
    Newton loops are solver-agnostic; every solve's ``SolveResult`` is
    appended to ``factory.results``.  Tuning keys: ``linear_rtol``
    (default 1e-10), ``gmres_restart`` (400), ``gmres_maxiter`` (10
    cycles).  On a tensor-product strip lattice (``node_positions``) the
    solver uses the stencil (DIA) matvec (``gmres_lattice: false`` opts
    out)."""
    mode = str(cfg.get("linear_solver", "lu")).lower()
    if mode in ("lu", "direct", "mumps"):
        return None
    if mode not in ("gmres", "iterative", "krylov"):
        raise ValueError(
            f"linear_solver must be 'lu' or 'gmres', got {mode!r}")
    from ..solvers.blocksolve import BlockNewtonKrylov, strip_dof_lattice

    dof_lattice = None
    if node_positions is not None and bool(cfg.get("gmres_lattice", True)):
        try:
            dof_lattice = strip_dof_lattice(node_positions)
        except ValueError:
            dof_lattice = None

    bks = BlockNewtonKrylov(
        element_dofs, n, ess_T, ess_p,
        restart=int(cfg.get("gmres_restart", 400)),
        maxiter=int(cfg.get("gmres_maxiter", 10)),
        dof_lattice=dof_lattice, device=device)
    rtol = float(cfg.get("linear_rtol", 1.0e-10))
    results = []

    class _Prepared:
        def __init__(self, factors):
            self.factors = factors

        def solve(self, rhs):
            res = bks.solve(self.factors, rhs, rtol=rtol)
            results.append(res)
            check_linear_result(res, "block GMRES")
            return res.x

    def factory(blocks, face=None, face_elem=None):
        return _Prepared(bks.prepare(blocks, face=face, face_elem=face_elem))

    factory.results = results
    return factory


def maybe_enable_lattice_residual(cfg: dict, sys_, fes):
    """Opt-in window-slicing ablation residual (YAML ``lattice_residual:
    true``): on tensor-product strip meshes the residual's per-element
    gather and scatter become strided windows
    (``AblationSystem.set_dof_lattice``).  Explicit opt-in raises if the
    mesh does not qualify rather than silently degrading."""
    if not bool(cfg.get("lattice_residual", False)):
        return False
    from ..solvers.blocksolve import strip_dof_lattice

    sys_.set_dof_lattice(strip_dof_lattice(fes.node_positions))
    print("lattice_residual: window-slicing residual path enabled "
          f"({sys_.lat.NY}x{sys_.lat.NX} dof lattice)")
    return True


def moving_mesh_and_ale_toggles(cfg: dict):
    """Resolve the case-2.2 mesh-motion/ALE switch set with the
    reference's composition (ablation_test_case2_2_2D.cpp:357-361, :3712;
    _test.cpp:4409-4416):

      moving_mesh (master)                -> recession machinery at all
      ale_mass_active   = moving_mesh && ale_enabled && ale_mass_enabled
      ale_energy_solid  = moving_mesh && ale_enabled && ale_energy_enabled
                          && ale_energy_solid_enabled
      ale_energy_gas    = moving_mesh && ale_enabled && ale_energy_enabled
                          && ale_energy_gas_enabled

    The production driver honours the per-term keys of the study variant
    too (the reference's production driver ignores them; every reference
    production config leaves them at their defaults, all true).
    ``recession_enabled`` (default true) AND-composes with
    ``moving_mesh``: setting either to false disables mesh motion.
    Validates ``mesh_smoothing_model`` like the reference (:483-491).
    Returns (moving, (ale_mass, ale_energy_solid, ale_energy_gas))."""
    smoothing = str(cfg.get("mesh_smoothing_model", "laplacian")).lower()
    if smoothing != "laplacian":
        raise ValueError('mesh_smoothing_model must be "laplacian".')
    moving = bool(cfg.get("moving_mesh", True)) \
        and bool(cfg.get("recession_enabled", True))
    ale = moving and bool(cfg.get("ale_enabled", True))
    ale_energy = ale and bool(cfg.get("ale_energy_enabled", True))
    toggles = (ale and bool(cfg.get("ale_mass_enabled", True)),
               ale_energy and bool(cfg.get("ale_energy_solid_enabled", True)),
               ale_energy and bool(cfg.get("ale_energy_gas_enabled", True)))
    return moving, toggles


def maybe_reorder_strip_mesh(cfg: dict, mesh):
    """With ``lattice_residual: true``, renumber strip-mesh elements
    row-major over the cell lattice (``ops.lattice2d.strip_element_order``)
    so the window-slicing residual path qualifies; GMSH transfinite meshes
    enumerate elements in generator order.  No-op for other configs or
    non-tensor meshes (the residual opt-in will then raise with a clear
    message).  Must run before any per-element state is built."""
    if not bool(cfg.get("lattice_residual", False)):
        return mesh
    from ..ops.lattice2d import reorder_mesh_elements, strip_element_order

    try:
        order = strip_element_order(mesh)
    except ValueError:
        return mesh
    if (order == np.arange(len(order))).all():
        return mesh
    print(f"lattice_residual: renumbered {len(order)} strip elements "
          "row-major over the cell lattice")
    cfg["_elem_order"] = "strip-row-major"
    return reorder_mesh_elements(mesh, order)
