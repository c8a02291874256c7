"""Steady convection-diffusion-reaction on the unit disk (radial MMS).

Port of ``cmfem_tpu/apps/linear_cd_2d_circle.py`` (the reference's
linear_convection_diffusion_2D_circle.cpp): u_exact(r) = (r^2-1) cos(2 pi r),
f = -kappa Lap(u) + c . grad(u) + s u; kappa=1, s=1, c=(1,1) defaults.
The analytic functions take numpy arrays and tensors alike.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .common import (
    parse_args, resolve_device, device_from_env, load_mesh_from_cfg,
    echo_config, validate_unit_circle,
)
from .linear_cd_2d import report_steady, solve_steady_cdr
from ..utils.yamlcfg import load_yaml

_ALPHA = 2.0 * np.pi
_SMALL_R = 1.0e-12
# r -> 0 limit of the Laplacian by symmetry: 2 u_rr(0) = 2 (2 + alpha^2)
_LAP_AT_0 = 2.0 * (2.0 + _ALPHA * _ALPHA)


def _xp(x):
    return torch if torch.is_tensor(x) else np


def _radius(x):
    return _xp(x).sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1])


def exact_u(r):
    return (r * r - 1.0) * _xp(r).cos(_ALPHA * r)


def exact_u_r(r):
    xp = _xp(r)
    return 2.0 * r * xp.cos(_ALPHA * r) \
        - _ALPHA * (r * r - 1.0) * xp.sin(_ALPHA * r)


def exact_u_rr(r):
    xp = _xp(r)
    return (2.0 * xp.cos(_ALPHA * r) - 4.0 * _ALPHA * r * xp.sin(_ALPHA * r)
            - _ALPHA * _ALPHA * (r * r - 1.0) * xp.cos(_ALPHA * r))


def exact_laplacian(r):
    xp = _xp(r)
    safe = xp.where(r > _SMALL_R, r, 1.0)
    lap = exact_u_rr(r) + exact_u_r(safe) / safe
    return xp.where(r > _SMALL_R, lap, _LAP_AT_0)


def make_mms(kappa, s, cx, cy):
    def exact(x):
        return exact_u(_radius(x))

    def forcing(x):
        xp = _xp(x)
        r = _radius(x)
        u = exact_u(r)
        lap = exact_laplacian(r)
        safe = xp.where(r > _SMALL_R, r, 1.0)
        rs = xp.where(r > _SMALL_R, exact_u_r(r) / safe, 0.0)
        ux, uy = rs * x[:, 0], rs * x[:, 1]
        return -kappa * lap + cx * ux + cy * uy + s * u

    return exact, forcing


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace
    from ..solvers import jacobi_preconditioner

    device = resolve_device(device)
    order = int(cfg.get("order", 1))
    kappa = float(cfg.get("kappa", 1.0))
    s = float(cfg.get("s", 1.0))
    cx = float(cfg.get("cx", 1.0))
    cy = float(cfg.get("cy", 1.0))
    if "convection" in cfg:
        cx, cy = [float(v) for v in cfg["convection"]]
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "convection_diffusion_2D_circle")
    error_csv = cfg.get("error_csv", "error_history_2D_circle.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    if kappa <= 0:
        raise ValueError("kappa must be > 0.")

    mesh = load_mesh_from_cfg(cfg)
    validate_unit_circle(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    exact, forcing = make_mms(kappa, s, cx, cy)
    ops, u, res, secs = solve_steady_cdr(
        cfg, fes, exact, forcing, kappa, s, cx, cy,
        lambda a, data, bc: jacobi_preconditioner(
            torch.where(bc.mask, 1.0, a.assemble_diagonal(data))),
        restart=100, maxiter=80, device=device, dtype=dtype)
    abs_l2, rel_l2 = report_steady(ops, fes, u, exact, output_path,
                                   error_csv, collection_name, save_paraview)
    return {"abs_l2": abs_l2, "rel_l2": rel_l2, "u": u.cpu().numpy(),
            "fes": fes, "solve": res, "solve_seconds": secs}


def main(argv=None):
    args = parse_args("Input/input_2d_circle.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
