"""Linear elasticity: cantilever beam static solve (BASELINE config #5).

Port of ``cmfem_tpu/apps/elasticity.py``: vector-H1 (order 2 default)
isotropic elasticity
  -div(sigma(u)) = f,  sigma = lam tr(eps) I + 2 mu eps,
clamped at x=0, end traction or body load; CG + Jacobi.  2D (plane strain)
or 3D, on generated cantilever meshes.  Verified against the Euler-Bernoulli
tip deflection in tests.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .common import (parse_args, resolve_device, device_from_env,
                     echo_config, ensure_outdir, check_standalone_linear)
from ..utils.yamlcfg import load_yaml
from ..utils.timing import StepTimer
from ..io import CsvWriter, VTUCollection


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace, make_cartesian_mesh_2d, make_cartesian_mesh_3d
    from ..ops import SpaceOps
    from ..ops.bc import EssentialBC
    from ..ops.vector import (
        VectorBilinearForm, vector_domain_lf, vector_boundary_lf,
    )
    from ..solvers import cg, jacobi_preconditioner

    device = resolve_device(device)
    dim = int(cfg.get("dim", 2))
    order = int(cfg.get("order", 2))
    L = float(cfg.get("length", 1.0))
    H = float(cfg.get("height", 0.1))
    nx = int(cfg.get("nx", 40))
    ny = int(cfg.get("ny", 4))
    nz = int(cfg.get("nz", 4))
    E = float(cfg.get("youngs_modulus", 1.0e6))
    nu = float(cfg.get("poisson_ratio", 0.3))
    tip_traction = float(cfg.get("tip_traction", -100.0))  # per unit area, y
    body_force_y = float(cfg.get("body_force_y", 0.0))
    output_path = cfg.get("output_path", "ParaView/elasticity")
    save_paraview = bool(cfg.get("save_paraview", True))

    # plane-strain Lame parameters (2D) / 3D Lame parameters
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))

    timer = StepTimer()
    with timer.phase("assemble"):
        if dim == 2:
            mesh = make_cartesian_mesh_2d(nx, ny, sx=L, sy=H)
            left_attr, right_attr = 4, 2
        else:
            mesh = make_cartesian_mesh_3d(nx, ny, nz, sx=L, sy=H, sz=H)
            left_attr, right_attr = 6, 4
        fes = FESpace(mesh, order, vdim=dim)
        n = fes.nscalar
        print(f"Vector dofs: {n * dim}")
        ops = SpaceOps(fes, device=device, dtype=dtype)

        form = VectorBilinearForm(ops, vdim=dim).add_elasticity(lam, mu)
        C = form.assemble()

        def y_load(value):
            def f(x):
                g = torch.zeros((x.shape[0], dim), dtype=x.dtype,
                                device=x.device)
                g[:, 1] = value
                return g
            return f

        b = torch.zeros(n * dim, dtype=dtype, device=device)
        if body_force_y != 0.0:
            b = b + vector_domain_lf(ops, y_load(body_force_y), vdim=dim)
        if tip_traction != 0.0:
            b = b + vector_boundary_lf(ops, y_load(tip_traction),
                                       attr_marker=[right_attr], vdim=dim)

        ess_scalar = fes.boundary_dofs([left_attr])
        ess = np.concatenate([np.asarray(ess_scalar) + c * n
                              for c in range(dim)])
        bc = EssentialBC(n * dim, ess, device=device)
        apply_A = lambda u: form.apply(C, u)
        B = bc.constrained_rhs(apply_A, b, torch.zeros_like(b))
        diag = torch.where(bc.mask, 1.0, form.assemble_diagonal(C))
    with timer.phase("solve"):
        res = cg(bc.constrain_operator(apply_A), B,
                 M=jacobi_preconditioner(diag),
                 rtol=float(cfg.get("solver_rtol", 1e-10)),
                 maxiter=int(cfg.get("solver_maxiter", 5000)))
        check_standalone_linear(res, "CG")
        u = res.x.cpu().numpy()

    with timer.phase("output"):
        # tip deflection: mean u_y over the free-end boundary nodes
        tip_dofs = np.asarray(fes.boundary_dofs([right_attr]))
        tip_deflection = float(u[n + tip_dofs].mean())
        print(f"CG iterations: {int(res.iters)}")
        print(f"Tip deflection (mean u_y at x=L): {tip_deflection:.6e}")

        ensure_outdir(output_path)
        with CsvWriter(os.path.join(output_path, "elasticity_summary.csv"),
                       ["metric", "value"]) as w:
            w.writerow(["tip_deflection", tip_deflection])
            w.writerow(["cg_iterations", int(res.iters)])
            w.writerow(["dofs", n * dim])
        if save_paraview:
            dc = VTUCollection("elasticity", fes, prefix_path=output_path)
            disp = np.stack([u[c * n:(c + 1) * n] for c in range(dim)],
                            axis=1)
            dc.save(0, 0.0, {"displacement": disp})

    return {"u": u, "tip_deflection": tip_deflection, "fes": fes,
            "iters": int(res.iters), "lam": lam, "mu": mu,
            "converged": bool(res.converged), "solve": res,
            "timing": [timer.step_reset()]}


def main(argv=None):
    args = parse_args("Input/input_elasticity.yaml", argv)
    cfg = load_yaml(args.input) if os.path.exists(args.input) else {}
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
