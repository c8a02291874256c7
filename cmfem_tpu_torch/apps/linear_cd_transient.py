"""Transient convection-diffusion with 3 uncoupled Peclet cases.

Port of ``cmfem_tpu/apps/linear_cd_transient.py`` (the reference's
linear_convection_diffusion_1D.cpp):
  dc/dt + beta . grad c - (1/Pe) Lap c = 0 on (0,1)^2, beta = (1,0),
implicit stepping; Dirichlet from the erfc-based analytic solution on
the x-boundaries, natural Neumann on y; per-step L2 errors for all
three Pe cases to one CSV (step,time,abs_l2_pe1,rel_l2_pe1,...).

The constant operators are assembled once.  Stepping defaults to backward
Euler (the reference's integrator); `time_integrator: sdirk2|sdirk3`
switches to the L-stable SDIRK schemes of solvers/timeint.py.  Stage
Dirichlet data is imposed by value (g at the stage times): the erfc
solution is sqrt(t)-singular at t=0, so the derivative-consistent stage BCs
that recover full tableau order for smooth data (see solvers/timeint.py)
integrate an unbounded initial boundary derivative here and lose accuracy.

`scan_stepping: true` is the JAX driver's one-program time loop: here a
plain loop that keeps the Dirichlet schedule and the per-step errors on the
device and reads them back once at the end (the host loop reads six floats
back per step).
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch
from scipy.special import erfc as _erfc

from .common import (
    parse_args, resolve_device, device_from_env, load_mesh_from_cfg,
    echo_config, ensure_outdir, validate_unit_square, x_boundary_attrs,
    num_steps, make_mg_preconditioner,
)
from ..utils.yamlcfg import load_yaml
from ..utils.timing import StepTimer
from ..io import CsvWriter, VTUCollection


def exp_times_erfc(a, b):
    """exp(a) * erfc(b) with the large-argument asymptotics of the
    reference (ExpTimesErfc); numpy arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    big = b > 26.0
    # asymptotic branch
    with np.errstate(over="ignore", invalid="ignore"):
        inv_b = np.where(big, 1.0 / np.where(big, b, 1.0), 0.0)
        inv_b2 = inv_b * inv_b
        erfc_asym = inv_b / np.sqrt(np.pi) * (1.0 - 0.5 * inv_b2 + 0.75 * inv_b2**2)
        expo = a - b * b
        asym = np.where(expo < -745.0, 0.0,
                        np.where(expo > 709.0, np.inf, np.exp(np.clip(expo, -745, 709)) * erfc_asym))
        direct = np.where(a > 709.0, np.inf,
                          np.exp(np.clip(a, None, 709)) * _erfc(b))
    return np.where(big, asym, direct)


def exp_times_erfc_torch(a, b):
    """exp(a)*erfc(b) on tensors with the same b>26 asymptotics."""
    big = b > 26.0
    inv_b = 1.0 / torch.where(big, b, 1.0)
    inv_b2 = inv_b * inv_b
    erfc_asym = inv_b / math.sqrt(math.pi) * (1.0 - 0.5 * inv_b2
                                              + 0.75 * inv_b2**2)
    asym = torch.exp(torch.clamp(a - b * b, -745.0, 709.0)) * erfc_asym
    direct = torch.exp(torch.clamp(a, max=709.0)) * torch.special.erfc(b)
    return torch.where(big, asym, direct)


def exact_concentration(x, t, pe):
    """Analytic erfc solution, uniform in y: x a numpy array (nodal
    interpolation on the host) or a tensor (evaluated on its device)."""
    on_device = torch.is_tensor(x)
    xp = torch if on_device else np
    if not on_device:
        x = np.asarray(x, dtype=np.float64)
    if t <= 0.0:
        return xp.zeros_like(x)
    diff = t / pe
    root = math.sqrt(diff)
    arg1 = (x - t) / (2.0 * root)
    arg2 = (x + t) / (2.0 * root)
    gauss = -((x - t) ** 2) / (4.0 * diff)
    term1 = 0.5 * (torch.special.erfc(arg1) if on_device else _erfc(arg1))
    term2 = math.sqrt(t * pe / math.pi) * xp.exp(gauss)
    ete = exp_times_erfc_torch if on_device else exp_times_erfc
    term3 = 0.5 * (1.0 + pe * x + pe * t) * ete(pe * x, arg2)
    c = term1 + term2 - term3
    return xp.where(xp.isfinite(c), c, 0.0)


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    from ..core import FESpace
    from ..ops import SpaceOps, BilinearForm, EssentialBC, l2_error, l2_norm_fn
    from ..solvers import (
        gmres, jacobi_preconditioner, get_tableau, make_linear_dirk_step,
        stage_times,
    )

    device = resolve_device(device)
    order = int(cfg.get("order", 1))
    dt = float(cfg.get("dt", 1.0e-3))
    tab = get_tableau(cfg.get("time_integrator", "be"))
    t_final = float(cfg.get("t_final", 1.0))
    peclet = [float(p) for p in cfg.get("peclet", [1.0, 10.0, 100.0])]
    if len(peclet) != 3:
        raise ValueError("YAML key peclet must be a sequence of exactly 3 values.")
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "convection_diffusion_3pe")
    error_csv = cfg.get("error_csv", "error_history.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 50))
    if paraview_every < 1:
        raise ValueError("paraview_every must be >= 1")
    if dt <= 0 or t_final < 0 or any(p <= 0 for p in peclet):
        raise ValueError("dt must be > 0, t_final >= 0, peclet > 0.")

    mesh = load_mesh_from_cfg(cfg)
    validate_unit_square(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    x_attrs = x_boundary_attrs(mesh)
    print(f"Dirichlet x-boundary attributes: {x_attrs}")
    ess = fes.boundary_dofs(x_attrs)
    bc = EssentialBC(fes.nscalar, ess, device=device)
    ess_x = torch.as_tensor(fes.node_positions[np.asarray(ess)][:, 0],
                            dtype=dtype, device=device)

    ops = SpaceOps(fes, device=device, dtype=dtype)
    mass = BilinearForm(ops).add_mass(1.0)
    mdata = mass.assemble()
    beta = np.array([1.0, 0.0])
    # every DIRK stage shares one operator M + gamma*dt*(C + K); for the
    # reference's BE (gamma=1) this is its once-assembled LHS
    gdt = tab.gamma * dt
    forms, datas, diags = [], [], []
    for pe in peclet:
        f = (BilinearForm(ops)
             .add_mass(1.0)
             .add_convection(beta, alpha=gdt)
             .add_diffusion(gdt / pe))
        d = f.assemble()
        forms.append(f)
        datas.append(d)
        diags.append(torch.where(bc.mask, 1.0, f.assemble_diagonal(d)))

    rtol = float(cfg.get("solver_rtol", 1e-12))
    restart = int(cfg.get("solver_restart", 60))
    maxiter = int(cfg.get("solver_maxiter", 60))

    # linear_solver: jacobi (default) | mg — one geometric hierarchy per
    # Peclet operator
    use_mg = str(cfg.get("linear_solver", "jacobi")).lower() == "mg"

    converged, arnoldi = [], []
    dirk_steps = []
    for k in range(3):
        apply_A = lambda v, d=datas[k], f=forms[k]: f.apply(d, v)
        apply_M = lambda v: mass.apply(mdata, v)
        if use_mg:
            # the PC must pin the SAME dofs as the system: x-boundaries
            # only (attribute ids survive uniform refinement)
            M = make_mg_preconditioner(
                cfg, order, lambda o, pe=peclet[k]: BilinearForm(o)
                .add_mass(1.0)
                .add_convection(beta, alpha=gdt)
                .add_diffusion(gdt / pe),
                ess_dofs=lambda fes_l: fes_l.boundary_dofs(x_attrs),
                device=device, dtype=dtype)
        else:
            M = jacobi_preconditioner(diags[k])

        def solve(op, B, x0, M=M):
            res = gmres(op, B, x0=x0, M=M, rtol=rtol, restart=restart,
                        maxiter=maxiter)
            converged.append(bool(res.converged))
            arnoldi.append(int(res.inner_iters))
            return res

        dirk_steps.append(
            make_linear_dirk_step(tab, dt, apply_M, apply_A, bc, solve))

    def step_all(cs, bdr_stages):
        """cs: (3, n); bdr_stages: (3, s, ness) stage Dirichlet values."""
        return torch.stack([dirk_steps[k](cs[k], None, bdr_stages[k])[0]
                            for k in range(3)])

    def stage_values(t):
        """(3, s, ness): the Dirichlet schedule of the step ending at t."""
        ts = stage_times(tab, t - dt, dt)
        return torch.stack(
            [torch.stack([exact_concentration(ess_x, ti, pe) for ti in ts])
             for pe in peclet])

    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}, nominal final time: {nsteps * dt}")

    ensure_outdir(output_path)
    csv = CsvWriter(os.path.join(output_path, error_csv),
                    ["step", "time",
                     "abs_l2_pe1", "rel_l2_pe1", "abs_l2_pe2", "rel_l2_pe2",
                     "abs_l2_pe3", "rel_l2_pe3"])
    dc = VTUCollection(collection_name, fes, prefix_path=output_path) \
        if save_paraview else None

    cs = torch.zeros((3, fes.nscalar), dtype=dtype, device=device)

    def errors(t):
        """(6,) tensor on the device: abs and rel L2 error of each case."""
        errs = []
        for k, pe in enumerate(peclet):
            ex = lambda x, pe=pe: exact_concentration(x[:, 0], t, pe)
            abs_l2 = l2_error(ops, cs[k], ex)
            nrm = l2_norm_fn(ops, ex)
            errs += [abs_l2, torch.where(nrm > 1e-14, abs_l2 / nrm, 0.0)]
        return torch.stack(errs)

    def write_errors(step, t):
        row = [step, t] + [float(v) for v in errors(t).cpu()]
        csv.writerow(row)
        if step <= 10 or step == nsteps or step % 50 == 0:
            print(f"step={step} t={t:g} relL2=[{row[3]:.3e}, {row[5]:.3e}, {row[7]:.3e}]")
        return row

    def save_fields(step, t):
        if dc is None or (step % paraview_every and step != nsteps):
            return
        fields = {}
        c_np = cs.cpu().numpy()
        for k, pe in enumerate(peclet):
            fields[f"c_pe{k+1}"] = c_np[k]
            fields[f"c_exact_pe{k+1}"] = fes.interpolate(
                lambda x: exact_concentration(x[:, 0], t, pe))
        dc.save(step, t, fields)

    write_errors(0, 0.0)
    save_fields(0, 0.0)

    last = None
    timer = StepTimer()
    timing = []
    # scan_stepping: the same loop with the per-step L2 errors left on the
    # device (as the Dirichlet schedule always is) and read back once per
    # run instead of once per step; fields are saved at the end only
    defer = bool(cfg.get("scan_stepping", False))
    hist = []
    for step in range(1, nsteps + 1):
        t = step * dt
        with timer.phase("solve"):
            cs = step_all(cs, stage_values(t))
        with timer.phase("errors_io"):
            if defer:
                hist.append(errors(t))
            else:
                last = write_errors(step, t)
                save_fields(step, t)
        timing.append(timer.step_reset())
    if hist:
        for step, vals in enumerate(torch.stack(hist).cpu().numpy(), 1):
            last = [step, step * dt] + [float(v) for v in vals]
            csv.writerow(last)
        save_fields(nsteps, nsteps * dt)

    csv.close()
    return {"final_errors": last, "c": cs.cpu().numpy(), "fes": fes,
            "converged": all(converged), "arnoldi": arnoldi,
            "timing": timing}


def main(argv=None):
    args = parse_args("Input/input.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
