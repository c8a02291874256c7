"""2D steady convection-diffusion-reaction driver (unit square MMS).

Port of ``cmfem_tpu/apps/linear_cd_2d.py`` (the reference's
linear_convection_diffusion_2D.cpp):
  -kappa Lap(u) + div(c u) + s u = f on the unit square, u = u_exact on Gamma,
  u_exact = sin(n pi x) sin(m pi y); same YAML keys, same CSV/ParaView
  outputs (abs_l2,rel_l2 -> error_csv; u/u_exact fields).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .common import (
    parse_args, resolve_device, device_from_env, load_mesh_from_cfg,
    echo_config, ensure_outdir, validate_unit_square,
    check_standalone_linear, make_mg_preconditioner,
)
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection


def make_mms(kappa, s, cx, cy, n, m):
    """(exact, forcing): both take numpy arrays and tensors alike."""

    def exact(x):
        xp = torch if torch.is_tensor(x) else np
        return xp.sin(n * np.pi * x[:, 0]) * xp.sin(m * np.pi * x[:, 1])

    def forcing(x):
        xp = torch if torch.is_tensor(x) else np
        nx = n * np.pi * x[:, 0]
        my = m * np.pi * x[:, 1]
        sin_nx, cos_nx = xp.sin(nx), xp.cos(nx)
        sin_my, cos_my = xp.sin(my), xp.cos(my)
        diff = kappa * (n * n + m * m) * np.pi**2 * sin_nx * sin_my
        conv = cx * n * np.pi * cos_nx * sin_my + cy * m * np.pi * sin_nx * cos_my
        return diff + conv + s * sin_nx * sin_my

    return exact, forcing


def solve_steady_cdr(cfg, fes, exact, forcing, kappa, s, cx, cy, M_for, *,
                     restart, maxiter, device, dtype):
    """The steady CDR solve both steady drivers share: assemble
    -kappa Lap + c . grad + s, impose u = exact on the whole boundary, GMRES
    with the preconditioner ``M_for(form, data, bc)``.  Returns (ops, u,
    SolveResult, solve seconds)."""
    from ..ops import SpaceOps, BilinearForm, EssentialBC, domain_lf
    from ..solvers import gmres

    ops = SpaceOps(fes, device=device, dtype=dtype)
    a = (BilinearForm(ops)
         .add_diffusion(kappa)
         .add_convection(np.array([cx, cy]))
         .add_mass(s))
    data = a.assemble()
    b = domain_lf(ops, forcing)

    bc = EssentialBC(fes.nscalar, fes.boundary_dofs(), device=device)
    u_bc = torch.as_tensor(fes.project_bdr(np.zeros(fes.nscalar), exact),
                           dtype=dtype, device=device)
    apply_A = lambda v: a.apply(data, v)
    B = bc.constrained_rhs(apply_A, b, u_bc)
    M = M_for(a, data, bc)
    t0 = time.perf_counter()
    res = gmres(bc.constrain_operator(apply_A), B, M=M,
                rtol=float(cfg.get("solver_rtol", 1e-12)),
                restart=int(cfg.get("solver_restart", restart)),
                maxiter=int(cfg.get("solver_maxiter", maxiter)))
    secs = time.perf_counter() - t0  # gmres ends on a device-to-host read
    check_standalone_linear(res)
    return ops, res.x, res, secs


def report_steady(ops, fes, u, exact, output_path, error_csv,
                  collection_name, save_paraview):
    """L2 errors printed and written to the CSV, fields to ParaView."""
    from ..ops import l2_error, l2_norm_fn

    abs_l2 = float(l2_error(ops, u, exact))
    exact_l2 = float(l2_norm_fn(ops, exact))
    rel_l2 = abs_l2 / exact_l2 if exact_l2 > 1e-14 else 0.0
    print(f"L2 error (absolute): {abs_l2}")
    print(f"L2 error (relative): {rel_l2}")

    ensure_outdir(output_path)
    with CsvWriter(os.path.join(output_path, error_csv),
                   ["abs_l2", "rel_l2"]) as w:
        w.writerow([abs_l2, rel_l2])

    if save_paraview:
        dc = VTUCollection(collection_name, fes, prefix_path=output_path)
        dc.save(0, 0.0, {"u": u.cpu().numpy(),
                         "u_exact": fes.interpolate(exact)})
    return abs_l2, rel_l2


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace
    from ..ops import BilinearForm
    from ..solvers import jacobi_preconditioner

    device = resolve_device(device)
    order = int(cfg.get("order", 1))
    kappa = float(cfg.get("kappa", 0.1))
    s = float(cfg.get("s", 1.0))
    cx = float(cfg.get("cx", 1.0))
    cy = float(cfg.get("cy", -2.0))
    if "convection" in cfg:
        cx, cy = [float(v) for v in cfg["convection"]]
    n_mode = int(cfg.get("mode_n", 3))
    m_mode = int(cfg.get("mode_m", 3))
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "convection_diffusion_2D")
    error_csv = cfg.get("error_csv", "error_history_2D.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    if order < 1:
        raise ValueError("order must be >= 1.")
    if kappa <= 0:
        raise ValueError("kappa must be > 0.")
    if n_mode <= 0 or m_mode <= 0:
        raise ValueError("mode_n and mode_m must be positive integers.")

    mesh = load_mesh_from_cfg(cfg)
    validate_unit_square(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    exact, forcing = make_mms(kappa, s, cx, cy, n_mode, m_mode)

    def M_for(a, data, bc):
        # linear_solver: jacobi (default) | mg
        if str(cfg.get("linear_solver", "jacobi")).lower() == "mg":
            return make_mg_preconditioner(
                cfg, order, lambda o: BilinearForm(o)
                .add_diffusion(kappa)
                .add_convection(np.array([cx, cy]))
                .add_mass(s), device=device, dtype=dtype)
        return jacobi_preconditioner(
            torch.where(bc.mask, 1.0, a.assemble_diagonal(data)))

    ops, u, res, secs = solve_steady_cdr(
        cfg, fes, exact, forcing, kappa, s, cx, cy, M_for, restart=80,
        maxiter=60, device=device, dtype=dtype)
    abs_l2, rel_l2 = report_steady(ops, fes, u, exact, output_path,
                                   error_csv, collection_name, save_paraview)
    return {"abs_l2": abs_l2, "rel_l2": rel_l2, "u": u.cpu().numpy(),
            "fes": fes, "solve": res, "solve_seconds": secs}


def main(argv=None):
    args = parse_args("Input/input_2d.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
