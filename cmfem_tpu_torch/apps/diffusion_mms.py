"""Static-mesh transient diffusion with manufactured solution.

Port of ``cmfem_tpu/apps/diffusion_mms.py`` (the reference's
diffusion_mms.cpp):
  du/dt - alpha Lap u = f,  u = sin(t) cos(q), q = 2(x-1/2)^2 + 2(y-1/2)^2,
Dirichlet everywhere from the exact solution; LHS M + alpha gamma dt K
assembled once; per-step CSV (step,time,l2_error,linf_error) +
u/u_exact/error fields.

Stepping defaults to backward Euler (the reference's only integrator);
`time_integrator: sdirk2|sdirk3` switches to the stiffly-accurate L-stable
SDIRK schemes (solvers/timeint.py).  The analytic functions take numpy
arrays (nodal interpolation on the host) and tensors (quadrature points on
the device) alike.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from .common import (
    parse_args, resolve_device, device_from_env, load_mesh_from_cfg,
    echo_config, ensure_outdir, num_steps, make_mg_preconditioner,
)
from ..utils.yamlcfg import load_yaml
from ..utils.timing import StepTimer
from ..io import CsvWriter, VTUCollection


def _xp(x):
    """The array module of x: torch for a tensor, numpy otherwise."""
    return torch if torch.is_tensor(x) else np


def exact(x, t):
    xp = _xp(x)
    dx = x[:, 0] - 0.5
    dy = x[:, 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    return math.sin(t) * xp.cos(q)


def exact_dt(x, t):
    xp = _xp(x)
    dx = x[:, 0] - 0.5
    dy = x[:, 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    return math.cos(t) * xp.cos(q)


def make_forcing(alpha):
    def forcing(x, t):
        xp = _xp(x)
        dx = x[:, 0] - 0.5
        dy = x[:, 1] - 0.5
        r2 = dx * dx + dy * dy
        q = 2.0 * r2
        ut = math.cos(t) * xp.cos(q)
        lap = math.sin(t) * (-16.0 * r2 * xp.cos(q) - 8.0 * xp.sin(q))
        return ut - alpha * lap

    return forcing


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace
    from ..ops import SpaceOps, BilinearForm, EssentialBC, domain_lf, l2_error
    from ..solvers import (
        cg, jacobi_preconditioner, get_tableau, make_linear_dirk_step,
        stage_times,
    )

    device = resolve_device(device)
    order = int(cfg.get("order", 1))
    alpha = float(cfg.get("alpha", 1.0))
    dt = float(cfg.get("dt", 1.0e-2))
    t_final = float(cfg.get("t_final", 1.0))
    # time_integrator: be (reference semantics) | sdirk2 | sdirk3
    tab = get_tableau(cfg.get("time_integrator", "be"))
    output_path = cfg.get("output_path", "ParaView")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 10))
    if paraview_every < 1:
        raise ValueError("paraview_every must be >= 1")
    if alpha <= 0 or dt <= 0 or t_final < 0:
        raise ValueError("alpha and dt must be > 0, t_final >= 0.")

    mesh = load_mesh_from_cfg(cfg)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    ops = SpaceOps(fes, device=device, dtype=dtype)
    mass = BilinearForm(ops).add_mass(1.0)
    mdata = mass.assemble()
    # all DIRK stages share one operator M + gamma*dt*K (gamma=1 for BE),
    # assembled once as a single fused form like the reference's BE LHS
    gdt = tab.gamma * dt
    lhs = BilinearForm(ops).add_mass(1.0).add_diffusion(alpha * gdt)
    ldata = lhs.assemble()
    forcing = make_forcing(alpha)

    ess = fes.boundary_dofs()
    bc = EssentialBC(fes.nscalar, ess, device=device)
    diag = torch.where(bc.mask, 1.0, lhs.assemble_diagonal(ldata))
    nodes = torch.as_tensor(fes.node_positions, dtype=dtype, device=device)
    ess_pts = nodes[bc.ess_dofs]

    rtol = float(cfg.get("solver_rtol", 1e-12))
    maxiter = int(cfg.get("solver_maxiter", 2000))

    # linear_solver: jacobi (default) | mg — geometric multigrid over the
    # driver's own refinement chain + p-coarsening, the production PC
    # analog of the reference's petsc*.opts AMG configurations
    solver = str(cfg.get("linear_solver", "jacobi")).lower()
    if solver == "mg":
        M = make_mg_preconditioner(
            cfg, order, lambda o: BilinearForm(o).add_mass(1.0)
            .add_diffusion(alpha * gdt), device=device, dtype=dtype)
    elif solver in ("jacobi", "cg"):
        M = jacobi_preconditioner(diag)
    else:
        raise ValueError(f"linear_solver must be 'jacobi' or 'mg', "
                         f"got {solver!r}")

    apply_A = lambda v: lhs.apply(ldata, v)
    apply_M = lambda v: mass.apply(mdata, v)
    converged = []

    def solve(op, B, x0):
        res = cg(op, B, x0=x0, M=M, rtol=rtol, maxiter=maxiter)
        converged.append(bool(res.converged))
        return res

    step_fn = make_linear_dirk_step(tab, dt, apply_M, apply_A, bc, solve)

    u = exact(nodes, 0.0)

    ensure_outdir(output_path)
    csv = CsvWriter(os.path.join(output_path, "error_history.csv"),
                    ["step", "time", "l2_error", "linf_error"])
    dc = VTUCollection("diffusion_mms", fes, prefix_path=output_path) \
        if save_paraview else None

    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}, dt={dt}, t_final={nsteps * dt}")

    def compute_and_save(step, t):
        l2 = float(l2_error(ops, u, lambda x: exact(x, t)))
        err = u - exact(nodes, t)
        linf = float(err.abs().max())
        csv.writerow([step, t, l2, linf])
        if step <= 5 or step % 50 == 0:
            print(f"step={step} t={t:g} L2_error={l2:.6e} Linf_error={linf:.6e}")
        if dc is not None and (step % paraview_every == 0 or step == nsteps):
            u_np = u.cpu().numpy()
            u_ex = fes.interpolate(lambda x: exact(x, t))
            dc.save(step, t, {"u": u_np, "u_exact": u_ex,
                              "error": u_np - u_ex})
        return l2, linf

    compute_and_save(0, 0.0)
    last = (0.0, 0.0)
    solve_iters = []
    timer = StepTimer()
    timing = []
    for step in range(1, nsteps + 1):
        t = step * dt
        ts = stage_times(tab, t - dt, dt)
        with timer.phase("rhs"):
            f_stages = torch.stack(
                [domain_lf(ops, lambda x: forcing(x, ti)) for ti in ts])
            g_stages = torch.stack([exact(ess_pts, ti) for ti in ts])
            # derivative-consistent stage BCs avoid RK order reduction
            gdot = torch.stack([exact_dt(ess_pts, ti) for ti in ts]) \
                if tab.order > 1 else None
        with timer.phase("solve"):
            u, iters = step_fn(u, f_stages, g_stages, gdot)
        solve_iters.append(int(iters))
        with timer.phase("errors_io"):
            last = compute_and_save(step, t)
        timing.append(timer.step_reset())

    csv.close()
    print(f"\nFinal L2 error at t={nsteps * dt}: {last[0]}")
    return {"final_l2": last[0], "final_linf": last[1],
            "u": u.cpu().numpy(), "fes": fes, "solve_iters": solve_iters,
            "converged": all(converged), "timing": timing}


def main(argv=None):
    args = parse_args("Input/input_diffusion_mms.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
