"""SCL-preserving ALE backward-Euler diffusion MMS on a fixed reference mesh.

Port of ``cmfem_tpu/apps/diffusion_mms_ale.py`` (the reference's
diffusion_mms_ale.cpp, Ivancic et al. Example 7.3): per step, on the
REFERENCE mesh,

  LHS = Mass(J_{n+1}) + Diffusion((alpha dt / J) C C^T)
        + Convection(phi_hat, -1) + Mass(-div phi_hat)
  RHS = Mass(J_n) u_old + dt * (f(A(xhat)) J, psi)

with the analytic maps' closed-form time-integrated grid flux phi_hat;
physical-domain L2 error via the J-weighted norm; `ale_displacement` /
`ale_jacobian` output fields for ParaView Warp-By-Vector.  The identity
map is the A/B fixture reproducing the static diffusion_mms driver.

The JAX driver runs each step's assembly and solve in one jit; here they
are eager torch on the device.  The analytic functions take numpy arrays
(nodal interpolation, VTU fields) and device tensors (quadrature points)
alike, as ``AleMap`` does.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from .common import (
    parse_args, resolve_device, device_from_env, load_mesh_from_cfg,
    echo_config, ensure_outdir, num_steps,
)
from ..utils.yamlcfg import load_yaml
from ..utils.timing import StepTimer
from ..io import CsvWriter, VTUCollection
from ..motion.ale import AleMap, _xp


def exact_physical(x, t):
    xp = _xp(x)
    dx = x[..., 0] - 0.5
    dy = x[..., 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    return math.sin(t) * xp.cos(q)


def forcing_physical(x, t, alpha):
    xp = _xp(x)
    dx = x[..., 0] - 0.5
    dy = x[..., 1] - 0.5
    r2 = dx * dx + dy * dy
    q = 2.0 * r2
    ut = math.cos(t) * xp.cos(q)
    lap = math.sin(t) * (-16.0 * r2 * xp.cos(q) - 8.0 * xp.sin(q))
    return ut - alpha * lap


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace
    from ..ops import SpaceOps, BilinearForm, EssentialBC, domain_lf
    from ..ops.assembly import weighted_l2_error
    from ..solvers import gmres, jacobi_preconditioner

    device = resolve_device(device)
    order = int(cfg.get("order", 1))
    alpha = float(cfg.get("alpha", 0.1))
    dt = float(cfg.get("dt", 0.05))
    t_final = float(cfg.get("t_final", 2.0))
    ale_map_name = cfg.get("ale_map", "accuracy_a")
    output_path = cfg.get("output_path", "ParaView/diffusion_mms_ale")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 1))
    lin_rtol = float(cfg.get("linear_rel_tol", 1e-10))
    lin_atol = float(cfg.get("linear_abs_tol", 0.0))
    lin_maxiter = int(cfg.get("linear_max_iter", 400))
    if alpha <= 0 or dt <= 0 or t_final < 0:
        raise ValueError("alpha and dt must be > 0, t_final >= 0")

    amap = AleMap(ale_map_name)
    print(f"ALE map: {amap.kind}")

    mesh = load_mesh_from_cfg(cfg)
    fes = FESpace(mesh, order)
    print(f"Scalar true dofs: {fes.nscalar}")
    ops = SpaceOps(fes, device=device, dtype=dtype)
    ess = fes.boundary_dofs()
    bc = EssentialBC(fes.nscalar, ess, device=device)
    ess_pts = torch.as_tensor(fes.node_positions[np.asarray(ess)],
                              dtype=dtype, device=device)

    def exact_ref(xhat, t):
        return exact_physical(amap.map_point(xhat, t), t)

    # reference semantics (diffusion_mms_ale.cpp:695-700): linear_max_iter
    # caps TOTAL Krylov iterations, and the restart length is
    # min(400, max(50, linear_max_iter)); gmres's maxiter counts restart
    # cycles, so derive it from the cap
    restart = min(400, max(50, lin_maxiter))
    cycles = max(1, -(-lin_maxiter // restart))

    def assemble(u, t_old, t_new):
        """The step's operator, its Jacobi diagonal and the constrained
        right-hand side."""
        # RHS part 1: Mass(J_n) u_old
        m_old = BilinearForm(ops).add_mass(
            lambda x: amap.jacobian_det(x, t_old))
        rhs = m_old.apply(m_old.assemble(), u)

        # LHS operator data at t_new
        a = BilinearForm(ops)
        a.add_mass(lambda x: amap.jacobian_det(x, t_new))

        def metric(x):
            C = amap.cofactor(x, t_new)
            J = amap.jacobian_det(x, t_new)
            return (alpha * dt / J)[..., None, None] * \
                torch.einsum("...ij,...kj->...ik", C, C)

        a.add_diffusion_matrix(metric)
        a.add_convection(lambda x: amap.integrated_grid_flux(x, t_old, t_new)[0],
                         alpha=-1.0)
        a.add_mass(lambda x: -amap.integrated_grid_flux(x, t_old, t_new)[1])
        data = a.assemble()

        # RHS part 2: dt * (f(A(xhat,t)) J, psi)
        rhs = rhs + dt * domain_lf(
            ops, lambda x: forcing_physical(amap.map_point(x, t_new), t_new,
                                            alpha) *
            amap.jacobian_det(x, t_new))

        u_bc = torch.zeros_like(u)
        u_bc[bc.ess_dofs] = exact_ref(ess_pts, t_new)
        apply_A = lambda v: a.apply(data, v)
        B = bc.constrained_rhs(apply_A, rhs, u_bc)
        diag = torch.where(bc.mask, 1.0, a.assemble_diagonal(data))
        return bc.constrain_operator(apply_A), B, diag

    u = torch.as_tensor(fes.interpolate(lambda x: exact_ref(x, 0.0)),
                        dtype=dtype, device=device)

    ensure_outdir(output_path)
    # l2_norm is the J-weighted physical-domain solution norm
    # ||u_h||_{L2(Omega(t))} — the quantity the paper-style stability
    # figure tracks (plot_ale_validation_be.py:40-60 reads it per dt)
    csv = CsvWriter(os.path.join(output_path, "error_history.csv"),
                    ["step", "time", "l2_error", "linf_error", "l2_norm"])
    dc = VTUCollection("diffusion_mms_ale", fes, prefix_path=output_path) \
        if save_paraview else None

    def compute_and_save(step, t, force=False):
        ex = lambda x: exact_ref(x, t)
        Jw = lambda x: amap.jacobian_det(x, t)
        l2 = float(weighted_l2_error(ops, u, ex, Jw))
        l2n = float(weighted_l2_error(
            ops, u, lambda x: torch.zeros_like(x[..., 0]), Jw))
        u_np = u.cpu().numpy()
        u_ex = fes.interpolate(ex)
        linf = float(np.max(np.abs(u_np - u_ex)))
        csv.writerow([step, t, l2, linf, l2n])
        if step <= 3 or step % 20 == 0:
            print(f"step={step}  t={t:.4f}  L2_error={l2:.6e}  "
                  f"Linf_error={linf:.6e}")
        if dc is not None and (force or (paraview_every > 0
                                         and step % paraview_every == 0)):
            pts = fes.node_positions
            dc.save(step, t, {
                "u": u_np, "u_exact": u_ex, "u_error": u_np - u_ex,
                "ale_displacement": amap.map_point(pts, t) - pts,
                "ale_jacobian": amap.jacobian_det(pts, t),
            })
        return l2, linf

    compute_and_save(0, 0.0, force=True)
    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}  dt={dt}  t_final={nsteps * dt}")

    t = 0.0
    last = (0.0, 0.0)
    timer = StepTimer()
    timing, krylov_iters = [], []
    for step in range(1, nsteps + 1):
        t_old = t
        t = t + dt
        with timer.phase("assemble"):
            A, B, diag = assemble(u, t_old, t)
        with timer.phase("solve"):
            res = gmres(A, B, x0=u, M=jacobi_preconditioner(diag),
                        rtol=lin_rtol, atol=lin_atol, restart=restart,
                        maxiter=cycles)
            # usable = converged | stagnated-at-working-precision-floor (the
            # deck rtols target f64; see common.check_standalone_linear)
            if not (res.converged or res.stagnated):
                raise RuntimeError(f"Linear solver failed at step {step}: "
                                   f"residual={res.residual}")
            u = res.x
        krylov_iters.append(int(res.inner_iters))
        with timer.phase("errors_io"):
            last = compute_and_save(step, t, force=(step == nsteps))
        timing.append(timer.step_reset())

    csv.close()
    print(f"\nFinal L2 error at t={t}:  {last[0]}")
    return {"final_l2": last[0], "final_linf": last[1],
            "u": u.cpu().numpy(), "fes": fes, "converged": True,
            "timing": timing, "krylov_iters": krylov_iters}


def main(argv=None):
    args = parse_args("Input/input_diffusion_mms_ale.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
