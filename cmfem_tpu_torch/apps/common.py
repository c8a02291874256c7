"""Shared app-driver scaffolding: CLI, device choice, mesh setup, config echo.

Port of the linear half of ``cmfem_tpu/apps/common.py``.  Each app mirrors
one reference driver: parse `-i input.yaml`, echo config, build mesh/space,
run, write CSV + ParaView.  A driver's ``run(cfg, device=None)`` runs on the
CUDA device and raises without one; ``device="cpu"``, or ``CMFEM_FORCE_CPU=1``
for ``main()``, asks for the CPU.  The drivers default to float64 (native
on the GPU), so the decks' tolerances (``solver_rtol: 1e-12``) are
reachable; the float32-floor acceptance of ``check_standalone_linear`` stays
for a caller who passes ``dtype=torch.float32``."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import require_cuda
from ..core import load_gmsh, Mesh
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
