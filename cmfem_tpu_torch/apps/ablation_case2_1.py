"""Ablation test case 2.1: surface-energy-balance top BC + restart.

Port of ``cmfem_tpu/apps/ablation_case2_1.py`` (the reference's
ablation_test_case2_1_2D.cpp): case 1 plus the SEB boundary integrator (B'
thermochemistry, blowing correction, chemistry/cooling branches,
``pato_compat_mode: cooling_exact``), the area-averaged boundary
diagnostics CSV, the B' clamp statistics CSV, and the restart checkpoint
(an .npz with a magic, version and world-size header, the T/p DOF vectors
and the per-QP reaction state; the JAX package's keys and dtypes, so each
package reads the other's checkpoints).

When the configured B' table is missing a clearly-labelled synthetic
table with the right shape is substituted, as in the JAX driver
(validation needs the real deck either way).

``run(cfg, device=None, dtype=torch.float64)``:

- the eager path evaluates the residual with the SEB face term, the AD
  element and face Jacobians on the device; ``linear_solver: lu`` (the
  default) solves each Newton system with a host ``splu`` over the blocks,
  ``gmres`` with the equilibrated point-block GMRES on the device;
  ``top_thermal_bc: temperature_dirichlet`` replaces the SEB with a
  (scheduled) wall temperature; ``jacobian_check`` checks the domain
  blocks at step 1 and the domain + face blocks once per flux branch;
  restart checkpoints are written every N steps, at a time, and at the end;
- ``scan_stepping: true`` (``run_scan``) keeps the step on the device: the
  Newton loop of ``common.scan_newton`` with ``make_scan_block_solver``'s
  solver (the block-QR direct solver with the SEB face blocks on an
  order-1 strip), the state advance, the probes and the boundary
  diagnostics, read back once per ``output_every`` frame.  The JAX package
  fuses each frame into one ``lax.scan`` program and evaluates the
  schedule with ``jnp.interp`` on the device; here the loop runs on the
  host and evaluates each step's ``BoundaryState`` and flux branch with
  ``schedule.eval``, as the eager path does (the same values to rounding),
  so no segmentation at branch changes is needed, and restart triggers
  land on their exact steps.

Float64 only. The eager path is ``apps.ablation_loop``'s loop over
``Case21``'s hooks; ``sharding_devices: N`` and ``dof_partition: N`` run it
on every rank of a world of N with the Newton iterate distributed, one
instance per flux branch (``apps.distributed``; rank 0 writes the files);
``scan_stepping`` refuses them. ``run`` returns the JAX driver's keys plus
``converged``, ``timing`` (per step: residual and jacobian with the SEB face
terms inside, factorization, linear, update, state, output, total seconds;
on the eager path the loop's spans and counts too), ``newton_iters``
(linear solves per step) and, with ``jacobian_check``, its results
(``"domain"`` and each flux branch: the max relative error, None where the
check was skipped).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _time

import numpy as np
import torch

from . import ablation_loop
from .ablation_case1 import Case1
from .ablation_loop import TIMING_KEYS
from .common import (
    device_from_env, device_sync, echo_config, linear_usable,
    load_newton_config, num_steps, parse_args, replay_newton_history,
    resolve_device, scan_newton, NewtonStallStats,
)
from .distributed import run_on_ranks
from ..io import CsvWriter, writes_files
from ..utils.timing import StepTimer, host_sync
from ..utils.yamlcfg import load_yaml, resolve_path

RESTART_MAGIC = 0x41424C32525A5441
RESTART_VERSION = 1
RESTART_TIME_TOL = 1e-12


def save_restart(path, step, time, T, p, extent, world_size=1,
                 elem_order="file"):
    """Write a checkpoint (numpy arrays or tensors on any device); a rank
    that writes no files (``io.output``) writes nothing."""
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)
    if not writes_files():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, magic=np.uint64(RESTART_MAGIC),
             version=np.uint32(RESTART_VERSION),
             world_size=np.int32(world_size),
             elem_order=np.str_(elem_order),
             step=np.int64(step), time=np.float64(time),
             T=host(T), p=host(p), extent=host(extent))


def load_restart(path, n, ne, nq, nr, world_size=1, elem_order="file"):
    """(step, time, T, p, extent) of a checkpoint, as numpy arrays; raises
    ValueError on a wrong magic, version, world size, element ordering or
    shape."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as d:
        if int(d["magic"]) != RESTART_MAGIC:
            raise ValueError(f"Invalid restart checkpoint magic in: {path}")
        if int(d["version"]) != RESTART_VERSION:
            raise ValueError(f"Unsupported restart checkpoint version in: {path}")
        if int(d["world_size"]) != world_size:
            raise ValueError(
                f"Restart checkpoint world size mismatch for {path} "
                f"(file={int(d['world_size'])}, run={world_size}).")
        # lattice_residual renumbers mesh elements (and, at order >= 2,
        # interior dofs), so state written under one ordering cannot be
        # resumed under the other (pre-tag checkpoints default to "file")
        file_order = str(d["elem_order"]) if "elem_order" in d else "file"
        if file_order != elem_order:
            raise ValueError(
                f"Restart element-order mismatch for {path}: checkpoint "
                f"was written with elem_order={file_order!r} but this run "
                f"uses {elem_order!r} (toggle 'lattice_residual' to match).")
        T = d["T"]; p = d["p"]; X = d["extent"]
        if len(T) != n or len(p) != n:
            raise ValueError(f"Restart true-dof size mismatch in: {path}")
        if X.shape != (ne, nq, nr):
            raise ValueError(f"Restart reaction-state shape mismatch in: {path}")
        return int(d["step"]), float(d["time"]), T, p, X


_BOUNDARY_DIAG_KEYS = (
    "m_dot_g_surf", "BprimeG_surf", "BprimeC_surf", "h_w_surf",
    "emissivity_surf", "absorptivity_surf", "reflectivity_surf",
    "blowing_correction_surf", "q_conv_surf", "q_adv_pyro_surf",
    "q_rad_emit_surf", "q_rad_abs_surf", "q_surf")


def _make_case21_csvs(cfg, output_path, probe_y):
    """The case-2.1 CSV streams (reference column schemas), shared by the
    eager and scan paths."""
    return {
        "probes": CsvWriter(
            os.path.join(output_path,
                         cfg.get("probes_csv", "temperature_probes.csv")),
            ["time", "wall"] + [f"TC{i}" for i in range(1, len(probe_y))]),
        "mass": CsvWriter(
            os.path.join(output_path, cfg.get("mass_csv", "mass_metrics.csv")),
            ["time", "m_dot_g_surf", "m_dot_c", "front_98_virgin",
             "front_2_char", "recession"]),
        "boundary": CsvWriter(
            os.path.join(output_path,
                         cfg.get("boundary_csv", "boundary_diagnostics.csv")),
            ["time"] + list(_BOUNDARY_DIAG_KEYS)),
        "newton": CsvWriter(
            os.path.join(output_path,
                         cfg.get("newton_csv",
                                 "newton_history_ablation_case2_1_2D.csv")),
            ["step", "time", "iter", "residual", "residual0", "rel_residual",
             "update_norm", "update0", "rel_update", "converged"]),
        "timing": CsvWriter(
            os.path.join(output_path,
                         cfg.get("timing_step_csv",
                                 "driver_timing_per_step.csv")),
            ["step", "bc_sec", "newton_sec", "newton_residual_eval_sec",
             "newton_jacobian_sec", "newton_linear_sec", "newton_update_sec",
             "state_advance_sec", "output_sec", "step_total_sec"]),
    }


def _write_case21_final_csvs(cfg, output_path, bprime):
    """Acceptance-tolerance echo + B' clamp statistics."""
    acc = cfg.get("acceptance", {})
    with CsvWriter(os.path.join(output_path,
                                "amaryllis_error_tolerances.csv"),
                   ["signal", "tolerance"]) as w:
        for key, default in (
                ("temperature_rmse_max", 250.0),
                ("temperature_max_abs_max", 500.0),
                ("m_dot_g_rmse_max", 0.02), ("m_dot_g_max_abs_max", 0.06),
                ("m_dot_g_peak_rel_error_max", 0.5),
                ("m_dot_g_peak_time_error_max", 10.0),
                ("front98_max_abs_max", 0.01), ("front98_rmse_max", 0.01),
                ("front2_max_abs_max", 0.01), ("front2_rmse_max", 0.01),
                ("m_dot_c_max_abs_max", 1.0e-8),
                ("recession_max_abs_max", 1.0e-8)):
            w.writerow([key, float(acc.get(key, default))])
    with CsvWriter(os.path.join(output_path, "bprime_clamp_stats.csv"),
                   ["axis", "clamp_count"]) as w:
        w.writerow(["pressure", bprime.clamp_stats.p])
        w.writerow(["BprimeG", bprime.clamp_stats.bg])
        w.writerow(["temperature", bprime.clamp_stats.t])


def load_bprime_table(cfg):
    """The configured B' table, or a clearly-labelled synthetic one with
    the right shape when the file is missing (as the JAX drivers do)."""
    from ..physics.bprime import BPrimeTable

    bprime_cfg = cfg.get("bprime_table_file", "")
    bprime_path = resolve_path(cfg, bprime_cfg) if bprime_cfg else ""
    if bprime_path and os.path.isfile(bprime_path):
        return BPrimeTable.load_file(bprime_path)
    print(f"B' table not found ({bprime_path!r}); using synthetic "
          f"TACOT-shaped table (NOT validation data).")
    return BPrimeTable.synthetic_tacot()


class Case21(Case1):
    """The set-up of a case-2.1 run: case 1's (mesh, deck, space, system,
    stencils, host LU) with the SEB model, the B' table, the surface
    schedule and the face blocks in place of the Dirichlet wall."""

    NAME = "ablation_case2_1"
    DEFAULTS = {"material_file": "Input/material_tacot_case2_1.yaml",
                "output_path": "ParaView/ablation_case2_1",
                "collection_name": "ablation_test_case2_1_2D",
                "probe_y": [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034,
                            0.026, 0.01]}

    def _init_boundary(self, cfg):
        from ..physics.seb import SurfaceFluxModel
        from ..physics.surface_bc import (SurfaceBCSchedule,
                                          TopTemperatureSchedule)

        top = str(cfg.get("top_thermal_bc", "surface_energy_balance")).lower()
        top = {"seb": "surface_energy_balance",
               "temp_dirichlet": "temperature_dirichlet",
               "temperature": "temperature_dirichlet"}.get(top, top)
        self.use_dirichlet = top == "temperature_dirichlet"
        # YAML 1.1 parses a bare `off` as boolean False
        compat = cfg.get("pato_compat_mode", "off")
        self.model = SurfaceFluxModel(
            lam=float(cfg.get("lambda", 0.5)),
            q_rad=float(cfg.get("q_rad", 0.0)),
            T_background=float(cfg.get("T_background", 300.0)),
            T_edge=float(cfg.get("T_edge", 300.0)),
            hconv=float(cfg.get("hconv", 0.0)),
            emissivity_override=float(cfg.get("emissivity", float("nan"))),
            absorptivity_override=float(cfg.get("absorptivity",
                                                float("nan"))),
            stefan_boltzmann=float(cfg.get("stefan_boltzmann",
                                           5.670374419e-8)),
            strict_case2_1=bool(cfg.get("strict_case2_1", True)),
            pato_compat_mode="off" if compat is False else str(compat).lower())
        if self.model.pato_compat_mode not in ("off", "cooling_exact"):
            raise ValueError(
                'pato_compat_mode must be either "off" or "cooling_exact".')
        self.bprime = load_bprime_table(cfg)
        self.schedule = SurfaceBCSchedule.load_file(resolve_path(
            cfg, cfg.get("boundary_conditions_file",
                         "Input/boundary_conditions_ablation_case2_1.dat")))
        self.top_T_value = float(cfg.get("top_temperature_value", 300.0))
        top_T_file = cfg.get("top_temperature_file", "")
        self.top_T_sched = TopTemperatureSchedule.load_file(
            resolve_path(cfg, top_T_file)) \
            if self.use_dirichlet and top_T_file else None

    @property
    def elem_order(self):
        """The element ordering checkpoints are tagged with
        (``maybe_reorder_strip_mesh`` sets it when it renumbers)."""
        return self.cfg.get("_elem_order", "file")

    def _ess_T(self):
        """Essential T DOFs: the top boundary only under a Dirichlet wall."""
        return self.ess if self.use_dirichlet \
            else np.zeros(0, dtype=self.ess.dtype)

    def _probe_points(self):
        """Every probe, the wall's included (the CSV's wall column is the
        field sampled at (probe_x, probe_y[0]))."""
        return np.array([[self.probe_x, y] for y in self.probe_y])

    def _make_csvs(self):
        self.csv = _make_case21_csvs(self.cfg, self.output_path,
                                     self.probe_y)
        self.newton_csv = self.csv["newton"]
        self.timing_csv = self.csv["timing"]
        self.csvs = list(self.csv.values())

    # -- the boundary of a step ---------------------------------------------

    def top_temperature_at(self, t):
        return self.top_T_sched.eval(t) if self.top_T_sched \
            else self.top_T_value

    def boundary(self, t):
        """(BoundaryState, flux branch) at time t, from the schedule."""
        from ..physics.seb import classify_branch

        bc = self.schedule.eval(t)
        return bc, classify_branch(bc, self.model)

    def enforce_bc(self, T, p, bc, t):
        T, p = T.clone(), p.clone()
        if self.use_dirichlet:
            T[self.ess_t] = self.top_temperature_at(t)
        p[self.ess_t] = bc.p_w
        return T, p

    def initial_fields(self):
        T = torch.full((self.n,), 300.0, dtype=self.dtype,
                       device=self.device)
        p = torch.full((self.n,), self.schedule.eval(0.0).p_w,
                       dtype=self.dtype, device=self.device)
        return self.enforce_bc(T, p, self.schedule.eval(0.0), 0.0)

    def seb(self, branch):
        return (branch, self.model, self.bprime)

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, bc, branch):
        RT, Rp = self.sys.residual(T, p, T_old_q, p_old_q, X_old, dt)
        if not self.use_dirichlet:
            RT = RT + self.sys.seb_face_residual(T, p, X_old, bc,
                                                 *self.seb(branch))
        return torch.where(self.mask2_t, 0.0, torch.cat([RT, Rp]))

    def face_jacobians(self, T, p, X_old, bc, branch):
        """The SEB face blocks (FJT, FJp), or None under a Dirichlet wall."""
        if self.use_dirichlet:
            return None
        return self.sys.seb_face_jacobians(T, p, X_old, bc,
                                           *self.seb(branch))

    # -- outputs -------------------------------------------------------------

    def boundary_values(self, T, p, X, bc, branch):
        """The boundary diagnostics of a state as one device vector
        (``AblationSystem.top_boundary_values``)."""
        return self.sys.top_boundary_values(T, p, X, bc, *self.seb(branch))

    def write_step(self, t, probe_vals, bvals, tau_elem):
        """The probe, mass and boundary rows of one output time from host
        values (``bvals``: a row of ``boundary_values``); adds the row's
        clamp counts to the table's statistics."""
        bdiag = self.sys.boundary_diagnostics_from_values(
            bvals, self.bprime, compute_surface_terms=not self.use_dirichlet)
        f98, f2 = self.fronts(tau_elem)
        self.csv["probes"].writerow([t] + [float(v) for v in probe_vals])
        self.csv["mass"].writerow([t, bdiag["m_dot_g_surf"], 0.0, f98, f2,
                                   0.0])
        self.csv["boundary"].writerow([t] + [bdiag[k] for k in
                                             _BOUNDARY_DIAG_KEYS])
        return bdiag

    def finish(self, totals, wall):
        _write_case21_final_csvs(self.cfg, self.output_path, self.bprime)
        self.close(totals, wall)

    # -- restart -------------------------------------------------------------

    def load_restart(self):
        """(step, t, T, p, state) from ``restart_read_file``, or None."""
        path = self.cfg.get("restart_read_file", "")
        if not path:
            return None
        sys_ = self.sys
        step, t, T, p, X = load_restart(
            resolve_path(self.cfg, path), self.n, sys_.ne, sys_.nq,
            self.mat.num_reactions, elem_order=self.elem_order)
        tens = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        T, p = tens(T), tens(p)
        # the element diagnostics are recomputed from the extents (dt 0)
        state = sys_.advance_state(
            dataclasses.replace(self.initial_state(), extent=tens(X)), T, p,
            0.0)
        print(f"Loaded restart from {path} at step {step}, time {t} s.")
        return step, t, T, p, state

    def save_checkpoint(self, path, step, t, T, p, X):
        save_restart(path, step, t, T, p, X, elem_order=self.elem_order)

    def restart_writer(self, t0):
        """``write(step, t_prev, t, T, p, extent)`` after each step (every
        ``restart_write_every`` steps, and the step that crosses
        ``restart_write_at_time``) and ``at_end(step, t, T, p, extent)``
        (``restart_write_at_end``, default on: the reference rewrites the
        checkpoint at the end, clobbering an at-time snapshot at the same
        path)."""
        cfg = self.cfg
        path = cfg.get("restart_write_file", "")
        every = int(cfg.get("restart_write_every", 0))
        at = cfg.get("restart_write_at_time", None)
        at = float(at) if at is not None else float("nan")
        at_end = bool(cfg.get("restart_write_at_end", True))
        pending = [np.isfinite(at) and t0 < at - RESTART_TIME_TOL]
        save = lambda *args: self.save_checkpoint(path, *args)

        def write(step, t_prev, t, T, p, X):
            if not path:
                return
            now = every > 0 and step % every == 0
            if (pending[0] and t_prev < at - RESTART_TIME_TOL
                    and t >= at - RESTART_TIME_TOL):
                now = True
                pending[0] = False
            if now:
                save(step, t, T, p, X)

        def end(step, t, T, p, X):
            if path and at_end:
                save(step, t, T, p, X)

        return write, end

    # -- the eager loop's hooks (apps.ablation_loop) -------------------------

    def start(self):
        """(step, t, T, p, state) where the run starts: the initial fields,
        or the checkpoint of ``restart_read_file``; ``nsteps`` counts the
        steps from there."""
        step, t = 0, 0.0
        T, p = self.initial_fields()
        state = self.initial_state()
        loaded = self.load_restart()
        if loaded is not None:
            step, t, T, p, state = loaded
        self.nsteps = num_steps(self.t_final - t, self.dt)
        print(f"Time steps: {self.nsteps}, nominal final time: "
              f"{self.t_final}")
        return step, t, T, p, state

    def stepping(self, step, t):
        """Whether a step follows: until ``t_final``."""
        return t < self.t_final - RESTART_TIME_TOL

    def step_args(self, s):
        return super().step_args(s) + s.bnd

    def jacobians(self, T, p, T_old_q, p_old_q, X_old, dt, bc, branch,
                  phase=None):
        """The element blocks and the SEB face blocks (None under a
        Dirichlet wall)."""
        return (self.sys.element_jacobians(T, p, T_old_q, p_old_q, X_old,
                                           dt),
                self.face_jacobians(T, p, X_old, bc, branch))

    def newton_instance(self, dn, s):
        """(instance, face bc) of step ``s``: one instance per flux branch
        (the branch changes the face residual), keyed "dirichlet" and with
        no face term under a Dirichlet wall; its slabs of the step's old
        state set."""
        bc, branch = s.bnd
        if self.use_dirichlet:
            inst, bc = dn.get("dirichlet"), None
        else:
            inst = dn.get(branch, seb=self.seb(branch))
        dn.set_step(inst, s.T_old_q, s.p_old_q, s.X_old)
        return inst, bc

    def check_jacobians(self, T, p, s, step, tol, results):
        """Case 1's check, then the domain + face blocks once per flux
        branch (``results[branch]``), None where a non-smooth state (a B'
        table clamp) skips it."""
        super().check_jacobians(T, p, s, step, tol, results)
        bc, branch = s.bnd
        if self.use_dirichlet or branch in results:
            return
        rel = results[branch] = self.sys.jacobian_check(
            T, p, s.T_old_q, s.p_old_q, s.X_old, s.dt, abs_tol=tol[0],
            rel_tol=tol[1], seb=self.seb(branch), bc=bc,
            **self.geometry_kw(s))
        if rel is None:
            print(f"jacobian_check (domain+face, branch={branch}) "
                  f"skipped: non-smooth state (B' table clamp active)")
        else:
            print(f"jacobian_check (domain+face, branch={branch}) "
                  f"passed (max rel err {rel:.3e})")

    def write_outputs(self, step, t, T, p, state):
        """The probe, mass and boundary rows of time t and its ParaView
        frame."""
        bc, branch = self.boundary(t)
        bvals = self.boundary_values(T, p, state.extent, bc, branch)
        host_sync(2)
        self.write_step(t, self.probes(T).cpu().numpy(),
                        bvals.cpu().numpy(), state.tau_elem)
        self.save_frame(step, t, T, p, state)

    def progress(self, step, t, bnd, iters, T, state):
        """The progress line of the first five steps and every 50th."""
        if step <= 5 or step % 50 == 0:
            host_sync()
            print(f"step={step} t={t:g} [{bnd[1]}] newton_iters={iters} "
                  f"Tmax={float(torch.max(T)):.1f}")

    def results(self, step, t, metrics):
        return {"step": step, "time": t, "bprime": self.bprime}


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    device = resolve_device(device)
    if cfg.get("scan_stepping", False):
        return run_scan(cfg, device=device, dtype=dtype)
    return run_on_ranks(__name__, _run, cfg, device, dtype)


def _run(cfg, device, dtype, option=None, nranks=0):
    return ablation_loop.run(Case21, cfg, device, dtype, option, nranks)


def run_scan(cfg: dict, device=None, dtype=torch.float64) -> dict:
    """Device-resident stepping (``scan_stepping: true``): each step's
    Newton solve (``scan_newton`` with ``make_scan_block_solver``'s
    solver, the SEB face blocks included), reaction-state advance, probes
    and boundary diagnostics stay on the device; the CSV rows and the
    Newton histories are read back once per ``output_every`` frame.  Same
    CSV schemas, ParaView cadence and restart triggers as the eager
    path."""
    from ..solvers.blocksolve import make_scan_block_solver

    device = resolve_device(device)
    if int(cfg.get("order", 1)) != 1:
        raise NotImplementedError("scan_stepping requires order 1")
    if int(cfg.get("sharding_devices", 0)) or int(cfg.get("dof_partition", 0)):
        raise NotImplementedError(
            "scan_stepping is mutually exclusive with sharding_devices / "
            "dof_partition")
    if bool(cfg.get("jacobian_check", False)):
        raise NotImplementedError(
            "jacobian_check is host-side; use the eager path")
    run_t0 = _time.perf_counter()
    c = Case21(cfg, device, dtype)
    sys_, ops, n = c.sys, c.ops, c.n
    newton_cfg = load_newton_config(cfg)
    lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
    bks = make_scan_block_solver(cfg, c.fes.element_dofs, n, c.ess_T, c.ess,
                                 c.fes.node_positions, device=device)
    print(f"scan_stepping: linear solver {type(bks).__name__}")
    timer = StepTimer(sync=device_sync(device))

    step0, t0 = 0, 0.0
    T, p = c.initial_fields()
    state = c.initial_state()
    loaded = c.load_restart()
    if loaded is not None:
        step0, t0, T, p, state = loaded
    c.nsteps = num_steps(c.t_final - t0, c.dt)
    t_edges = np.minimum(c.t_final, t0 + c.dt * np.arange(c.nsteps + 1))
    print(f"Time steps: {c.nsteps}, nominal final time: {t_edges[-1]}")
    write_restart, write_restart_at_end = c.restart_writer(t0)

    def diag_boundary(t):
        # under a Dirichlet wall the flux branch never reaches the step;
        # the diagnostics then take the JAX scan path's label ("dirichlet",
        # chemistry off), of which only m_dot_g_surf is written
        bc, branch = c.boundary(t)
        if c.use_dirichlet:
            bc = dataclasses.replace(bc, chemistryOn=0)
            branch = "dirichlet"
        return bc, branch

    X = state.extent
    bc, branch = c.boundary(t0)
    c.write_step(t0, c.probes(T).cpu().numpy(),
                 c.boundary_values(T, p, X, bc, branch).cpu().numpy(),
                 state.tau_elem)
    c.save_frame(step0, t0, T, p, state)

    def residual(T, p, T_old_q, p_old_q, X, dt, bc, branch):
        with timer.phase("residual"):
            return c.residual(T, p, T_old_q, p_old_q, X, dt, bc, branch)

    def make_solve(T_old_q, p_old_q, X, dt, bc, branch, t):
        def solve(T, p, R):
            with timer.phase("jacobian"):
                blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X, dt)
                face = c.face_jacobians(T, p, X, bc, branch)
            with timer.phase("factorization"):
                fac = bks.prepare(blocks, face=face,
                                  face_elem=sys_.trace.elem)
            with timer.phase("linear"):
                sol = bks.solve(fac, -R, rtol=lin_rtol)
            with timer.phase("update"):
                Tn, pn = c.enforce_bc(T + sol.x[:n], p + sol.x[n:], bc, t)
                un = torch.linalg.vector_norm(sol.x)
            krylov_step.append(sol.inner_iters)
            return Tn, pn, un, linear_usable(sol)
        return solve

    timing, newton_iters, krylov, frame = [], [], [], []
    stall_stats = NewtonStallStats()
    arrays = None
    for k in range(1, c.nsteps + 1):
        step = step0 + k
        t, dt = float(t_edges[k]), float(t_edges[k] - t_edges[k - 1])
        with timer.phase("state"):
            T_old_q = ops.values_at_qp(T)
            p_old_q = ops.values_at_qp(p)
        with timer.phase("bc"):
            bc, branch = c.boundary(t)
            T, p = c.enforce_bc(T, p, bc, t)
        krylov_step = []
        (T, p, it, r0, rn, done, res_h, upd_h, lin_ok,
         nw_stalled) = scan_newton(
            T, p,
            residual=lambda T, p: residual(T, p, T_old_q, p_old_q, X, dt,
                                           bc, branch),
            solve=make_solve(T_old_q, p_old_q, X, dt, bc, branch, t),
            config=newton_cfg)
        if not lin_ok:
            raise RuntimeError(
                f"block GMRES did not converge at step {step} "
                "(raise gmres_restart/gmres_maxiter)")
        if not done:
            raise RuntimeError(f"Newton did not converge at step {step}, "
                               f"final residual={float(rn)}")
        with timer.phase("state"):
            arrays = sys_.advance_state_arrays(X, T, p, dt)
            X = arrays[0]
        with timer.phase("output"):
            frame.append((step, t, c.probes(T),
                          c.boundary_values(T, p, X, *diag_boundary(t)),
                          arrays[1], it, r0, rn, res_h, upd_h, nw_stalled))
            if k % c.output_every == 0 or k == c.nsteps:
                _flush_frame(c, frame, stall_stats)
                frame = []
                state = sys_.state_from_arrays(*arrays)
                c.save_frame(step, t, T, p, state)
            write_restart(step, float(t_edges[k - 1]), t, T, p, X)
        timing.append(c.timing_row(step, timer.step_reset()))
        newton_iters.append(it - 1)
        krylov.append(krylov_step)
        if k <= 5 or k % 50 == 0:
            print(f"step={step} t={t:g} [{branch}] newton_iters={it - 1}")

    if arrays is not None:
        state = sys_.state_from_arrays(*arrays)
    write_restart_at_end(step0 + c.nsteps, float(t_edges[-1]), T, p, X)
    totals = {k: sum(r.get(k, 0.0) for r in timing)
              for k in TIMING_KEYS + ("newton", "total")}
    c.finish(totals, _time.perf_counter() - run_t0)
    wall = totals["total"]
    print(f"scan_stepping: {c.nsteps} steps in {wall:.2f}s "
          f"({wall * 1e3 / max(1, c.nsteps):.1f} ms/step)")
    return {"T": T.cpu().numpy(), "p": p.cpu().numpy(), "state": state,
            "fes": c.fes, "mesh": c.mesh, "step": step0 + c.nsteps,
            "time": float(t_edges[-1]), "bprime": c.bprime,
            "converged": True, "timing": timing,
            "newton_iters": newton_iters, "krylov_iters": krylov,
            "linear_solver": type(bks).__name__,
            "newton_stall_stats": stall_stats.summary()}


def _flush_frame(c, frame, stall_stats):
    """Read one output frame's per-step rows back from the device and write
    them to the CSVs."""
    (probes, bvals, taus, r0s, rns, res_hs, upd_hs, stalls) = [
        torch.stack([f[k] for f in frame]).cpu().numpy()
        for k in (2, 3, 4, 6, 7, 8, 9, 10)]
    stall_stats.update(stalls, rns, r0s)
    if stalls.any():
        print(f"WARNING: {int(stalls.sum())}/{len(frame)} steps accepted at "
              "the Newton working-precision stall floor (not the abs/rel "
              "tolerance)", flush=True)
    for k, (step, t, *_, it, _, _, _, _, _) in enumerate(frame):
        c.write_step(t, probes[k], bvals[k], taus[k])
        replay_newton_history(c.newton_csv, step, t, it, float(r0s[k]),
                              res_hs[k], upd_hs[k])


def main(argv=None):
    args = parse_args("Input/input_ablation_case2_1.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
