"""Ablation test case 1: coupled (T, p) pyrolysis with Dirichlet wall T.

Port of ``cmfem_tpu/apps/ablation_case1.py`` (the reference's
ablation_test_case1_2D.cpp): a TACOT strip heated by a tabulated
wall-temperature schedule at constant top pressure; per-QP reaction state;
a block Newton solve per step; probes / mass-metrics / newton / timing CSVs
and ParaView fields including per-reaction extents.

``run(cfg, device=None, dtype=torch.float64)``:

- the default path (``linear_solver: lu``) evaluates the residual and the
  AD element Jacobians on the device and solves each Newton system with a
  host sparse LU (scipy ``splu``) over the blocks copied back, as the JAX
  driver does; ``linear_solver: gmres`` solves on the device with the
  equilibrated point-block GMRES;
- ``scan_stepping: true`` keeps the whole step on the device: the Newton
  loop of ``common.scan_newton`` with ``make_scan_block_solver``'s solver
  (the block-QR direct solver on an order-1 strip), the state advance and
  the probe and mass rows, which are read back once per ``output_every``
  frame.

Case 1 runs in float64 only (the equilibrated Jacobian's condition number
is ~1e15); the JAX package's float32 stall machinery is kept in the Newton
loops, but no float32 run is offered.  The eager path is
``apps.ablation_loop``'s loop over ``Case1``'s hooks; ``sharding_devices:
N`` and ``dof_partition: N`` run it on every rank of a world of N with the
Newton iterate distributed (``apps.distributed``; rank 0 writes the
files).  ``run`` returns the JAX driver's keys plus ``converged``,
``timing`` (per step: residual, jacobian, factorization, linear, update,
state, output, total seconds and the loop's spans and counts) and
``newton_iters`` (linear solves per step).
"""

from __future__ import annotations

import os
import sys
import time as _time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from . import ablation_loop
from .ablation_loop import TIMING_KEYS, run_spans
from .common import (
    device_sync, echo_config, ensure_outdir, linear_usable,
    load_mesh_from_cfg, load_newton_config, maybe_enable_lattice_residual,
    maybe_reorder_strip_mesh, num_steps, parse_args, replay_newton_history,
    resolve_device, device_from_env, scan_newton, NewtonStallStats,
)
from .distributed import DistributedNewton, run_on_ranks
from ..io import CsvWriter, VTUCollection, writes_files
from ..utils.timing import StepTimer, host_copy, host_sync
from ..utils.yamlcfg import load_yaml, resolve_path


def evaluate_schedule(schedule, t):
    """Piecewise-linear (time, value) schedule (EvaluateSchedule)."""
    ts = np.asarray([s[0] for s in schedule])
    vs = np.asarray([s[1] for s in schedule])
    return float(np.interp(t, ts, vs))


DEFAULT_SCHEDULE = [
    [0.0, 300.0], [0.1, 1644.0], [60.0, 1644.0], [60.1, 300.0], [120.0, 300.0],
]


def _make_case1_csvs(cfg, output_path, probe_y):
    """The driver's four CSV streams (shared by the eager and scan paths)."""
    probes_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("probes_csv", "temperature_probes.csv")),
        ["time", "wall"] + [f"TC{i}" for i in range(1, len(probe_y))])
    mass_csv = CsvWriter(
        os.path.join(output_path, cfg.get("mass_csv", "mass_metrics.csv")),
        ["time", "m_dot_g_surf", "m_dot_c", "front_98_virgin",
         "front_2_char", "recession"])
    newton_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("newton_csv",
                             "newton_history_ablation_case1_2D.csv")),
        ["step", "time", "iter", "residual", "residual0", "rel_residual",
         "update_norm", "update0", "rel_update", "converged"])
    timing_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("timing_step_csv",
                             "driver_timing_per_step.csv")),
        ["step", "bc_sec", "newton_sec", "newton_residual_eval_sec",
         "newton_jacobian_sec", "newton_linear_sec", "newton_update_sec",
         "state_advance_sec", "output_sec", "step_total_sec"])
    return probes_csv, mass_csv, newton_csv, timing_csv


def _write_tolerances_csv(cfg, output_path):
    """Acceptance tolerance echo (fiat_error_tolerances.csv)."""
    acc = cfg.get("acceptance", {})
    with CsvWriter(os.path.join(output_path, "fiat_error_tolerances.csv"),
                   ["signal", "tolerance"]) as w:
        w.writerow(["temperature_rmse_max",
                    float(acc.get("temperature_rmse_max", 150.0))])
        w.writerow(["temperature_max_abs_max",
                    float(acc.get("temperature_max_abs_max", 300.0))])
        w.writerow(["m_dot_g_peak_rel_error_max",
                    float(acc.get("m_dot_g_peak_rel_error_max", 0.5))])
        w.writerow(["m_dot_g_peak_time_error_max",
                    float(acc.get("m_dot_g_peak_time_error_max", 10.0))])
        w.writerow(["front98_rmse_max",
                    float(acc.get("front98_rmse_max", 0.01))])
        w.writerow(["front2_rmse_max",
                    float(acc.get("front2_rmse_max", 0.01))])


def _write_timing_summary(cfg, output_path, totals, nsteps, wall):
    with CsvWriter(os.path.join(output_path,
                                cfg.get("timing_summary_csv",
                                        "driver_timing_summary.csv")),
                   ["metric", "seconds"]) as w:
        w.writerow(["setup_time_maxrank", wall - totals["total"]])
        w.writerow(["run_time_maxrank", wall])
        w.writerow(["sum_step_time_maxrank", totals["total"]])
        w.writerow(["sum_bc_time_maxrank", totals["bc"]])
        w.writerow(["sum_newton_time_maxrank", totals["newton"]])
        w.writerow(["sum_newton_residual_eval_time_maxrank",
                    totals["residual"]])
        w.writerow(["sum_newton_jacobian_time_maxrank",
                    totals["jacobian"] + totals["factorization"]])
        w.writerow(["sum_newton_linear_time_maxrank", totals["linear"]])
        w.writerow(["sum_newton_update_time_maxrank", totals["update"]])
        w.writerow(["sum_state_advance_time_maxrank", totals["state"]])
        w.writerow(["sum_output_time_maxrank", totals["output"]])
        w.writerow(["avg_step_time_maxrank",
                    totals["total"] / max(1, nsteps)])


class Case1:
    """The set-up of a case-1 run, shared by the eager and scan paths (and
    by the smoke run and the profiler, which drive its pieces alone):
    config, material, mesh, space, system, essential DOFs, the probe and
    front stencils, the CSV streams; and the eager loop's hooks
    (``apps.ablation_loop``).  Case 2.1 (``ablation_case2_1.Case21``)
    derives from it and replaces the boundary set-up (``_init_boundary``),
    the essential T DOFs (``ess_T``), the probe points, the CSVs and the
    hooks that differ."""

    NAME = "ablation_case1"
    # the Newton loop's iteration lines: five lines each, as the reference's
    NEWTON_PRINT_MULTILINE = True
    DEFAULTS = {"material_file": "Input/material_tacot_case1.yaml",
                "output_path": "ParaView/ablation_case1",
                "collection_name": "ablation_test_case1_2D",
                "probe_y": [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034,
                            0.026]}

    def __init__(self, cfg, device, dtype):
        from ..core import FESpace
        from ..core.pointlocate import front_line_stencil, \
            h1_sampling_stencil
        from ..ops import SpaceOps
        from ..physics.ablation import AblationSystem
        from ..physics.tacot import TacotMaterial

        if dtype != torch.float64:
            raise ValueError(f"{self.NAME} runs in float64 only (the "
                             "equilibrated Newton systems measure cond "
                             "~1e15)")
        self.cfg = cfg
        self.device, self.dtype = device, dtype
        self.material_file = resolve_path(
            cfg, cfg.get("material_file", self.DEFAULTS["material_file"]))
        self.order = int(cfg.get("order", 1))
        self.dt = float(cfg.get("dt", 1.0e-2))
        self.t_final = float(cfg.get("t_final", 120.0))
        self.output_every = int(cfg.get("output_every", 10))
        if self.output_every < 1:
            raise ValueError("output_every must be >= 1")
        self.output_path = cfg.get("output_path",
                                   self.DEFAULTS["output_path"])
        self.collection_name = cfg.get("collection_name",
                                       self.DEFAULTS["collection_name"])
        self.save_paraview = bool(cfg.get("save_paraview", True))
        self.bdr_top = int(cfg.get("bdr_attr_top", 1))
        gravity = (float(cfg.get("gravity_x", 0.0)),
                   float(cfg.get("gravity_y", 0.0)))
        self.probe_x = float(cfg.get("probe_x", 0.005))
        self.probe_y = [float(v) for v in cfg.get(
            "probe_y", self.DEFAULTS["probe_y"])]
        if self.dt <= 0 or self.t_final < 0 or self.order < 1:
            raise ValueError("invalid dt/t_final/order")
        self._init_boundary(cfg)

        self.mat = TacotMaterial.load_yaml(self.material_file)
        self.mesh = mesh = maybe_reorder_strip_mesh(cfg,
                                                    load_mesh_from_cfg(cfg))
        self.lo, self.hi = mesh.bounding_box()
        xmid = 0.5 * (self.lo[0] + self.hi[0])
        self.fes = fes = FESpace(mesh, self.order)
        self.n = n = fes.nscalar
        print(f"Global true dofs (T): {n}\nGlobal true dofs (p): {n}\n"
              f"Global true dofs (T+p): {2 * n}")
        self.ops = SpaceOps(fes, quad_order=max(2, 2 * self.order + 2),
                            device=device, dtype=dtype)
        self.sys = AblationSystem(self.ops, self.mat, gravity=gravity,
                                  top_attr=self.bdr_top)
        maybe_enable_lattice_residual(cfg, self.sys, fes)

        self.ess = np.asarray(fes.boundary_dofs([self.bdr_top]))
        self.ess_T = self._ess_T()
        mask2 = np.zeros(2 * n, dtype=bool)
        mask2[self.ess_T] = True
        mask2[self.ess + n] = True
        self.mask2 = mask2
        self.mask2_t = torch.as_tensor(mask2, device=device)
        self.ess_t = torch.as_tensor(self.ess, device=device)

        # fixed probe points and front line: located once (static mesh)
        pdofs, pweights = h1_sampling_stencil(fes, self._probe_points())
        self.pdofs = torch.as_tensor(pdofs, device=device)
        self.pweights = torch.as_tensor(pweights, dtype=dtype, device=device)
        self.front_line = front_line_stencil(mesh, xmid, self.hi[1],
                                             self.lo[1])
        self.nsteps = num_steps(self.t_final, self.dt)

        ensure_outdir(self.output_path)
        self._make_csvs()
        self.dc = VTUCollection(self.collection_name, fes,
                                prefix_path=self.output_path) \
            if self.save_paraview and writes_files() else None

    # -- the case-specific pieces ------------------------------------------

    def _init_boundary(self, cfg):
        """The top boundary's data: the wall-temperature schedule and the
        top pressure."""
        self.top_pressure = float(cfg.get("top_pressure", 101325.0))
        schedule = cfg.get("top_temperature_schedule", DEFAULT_SCHEDULE)
        self.schedule = sorted([[float(a), float(b)] for a, b in schedule])
        if not self.schedule:
            raise ValueError("top_temperature_schedule cannot be empty.")

    def _ess_T(self):
        """Essential T DOFs: the top boundary (Dirichlet wall)."""
        return self.ess

    def _probe_points(self):
        """The probes below the wall (the CSV's wall column is the
        schedule's value)."""
        return np.array([[self.probe_x, y] for y in self.probe_y[1:]])

    def _make_csvs(self):
        (self.probes_csv, self.mass_csv, self.newton_csv,
         self.timing_csv) = _make_case1_csvs(self.cfg, self.output_path,
                                             self.probe_y)
        self.csvs = [self.probes_csv, self.mass_csv, self.newton_csv,
                     self.timing_csv]

    def initial_state(self):
        from ..physics.ablation import AblationState

        return AblationState.initial(self.sys.ne, self.sys.nq, self.mat,
                                     device=self.device, dtype=self.dtype)

    def host_matrix(self, blocks, face=None):
        """The BC-eliminated 2n x 2n Jacobian (scipy CSR on the host)
        assembled from the element blocks and the boundary-face blocks of
        the T rows (``face=(FJT, FJp)``)."""
        n = self.n
        if not hasattr(self, "_rows_cols"):
            # static sparsity structure of the 2x2 block Jacobian and of the
            # face blocks (T rows only)
            pattern = lambda ed: (np.repeat(ed, ed.shape[1], axis=1)
                                  .reshape(-1),
                                  np.tile(ed, (1, ed.shape[1])).reshape(-1))
            rows_b, cols_b = pattern(np.asarray(self.fes.element_dofs,
                                                dtype=np.int64))
            self._rows_cols = (
                np.concatenate([rows_b, rows_b, rows_b + n, rows_b + n]),
                np.concatenate([cols_b, cols_b + n, cols_b, cols_b + n]))
            host_sync()
            rows_f, cols_f = pattern(self.sys.trace.eldofs.cpu().numpy())
            self._face_rows_cols = (np.concatenate([rows_f, rows_f]),
                                    np.concatenate([cols_f, cols_f + n]))
        rows, cols = self._rows_cols
        if face is not None:
            blocks = tuple(blocks) + tuple(face)
            rows = np.concatenate([rows, self._face_rows_cols[0]])
            cols = np.concatenate([cols, self._face_rows_cols[1]])
        host_sync()
        vals = torch.cat([b.reshape(-1) for b in blocks]).cpu().numpy()
        J = sp.coo_matrix((vals, (rows, cols)),
                          shape=(2 * n, 2 * n)).tocsr()
        # essential elimination: identity rows/cols
        d = sp.diags((~self.mask2).astype(np.float64))
        return d @ J @ d + sp.diags(self.mask2.astype(np.float64))

    def host_lu(self, blocks, face=None):
        """scipy ``splu`` of ``host_matrix`` (the reference's MUMPS LU
        analog); ``.solve(rhs)`` takes and returns device tensors."""
        J = self.host_matrix(blocks, face)
        lu = spla.splu(J.tocsc())

        class _LU:
            def solve(self, rhs):
                host_sync()
                x = lu.solve(rhs.cpu().numpy())
                host_copy(x, rhs.device)
                return torch.as_tensor(x, dtype=rhs.dtype, device=rhs.device)

        return _LU()

    def initial_fields(self):
        T = torch.full((self.n,), 300.0, dtype=self.dtype,
                       device=self.device)
        p = torch.full((self.n,), self.top_pressure, dtype=self.dtype,
                       device=self.device)
        return self.enforce_bc(T, p, evaluate_schedule(self.schedule, 0.0))

    def enforce_bc(self, T, p, Tbc, t=None):
        """(T, p) with the wall temperature ``Tbc`` and the top pressure on
        the top boundary (``t``, the time, is case 2.1's)."""
        T, p = T.clone(), p.clone()
        host_copy(Tbc, T.device)
        T[self.ess_t] = Tbc
        host_copy(self.top_pressure, p.device)
        p[self.ess_t] = self.top_pressure
        return T, p

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt):
        RT, Rp = self.sys.residual(T, p, T_old_q, p_old_q, X_old, dt)
        return torch.where(self.mask2_t, 0.0, torch.cat([RT, Rp]))

    def probes(self, T):
        return torch.sum(self.pweights * T[self.pdofs], dim=1)

    def fronts(self, tau_elem):
        from ..core.pointlocate import front_depth_static

        ids, ys = self.front_line
        return (front_depth_static(ids, ys, tau_elem, self.hi[1], 0.98),
                front_depth_static(ids, ys, tau_elem, self.hi[1], 0.02))

    def write_rows(self, t, probe_vals, mdot, tau_elem):
        f98, f2 = self.fronts(tau_elem)
        wall = evaluate_schedule(self.schedule, t)
        self.probes_csv.writerow([t, wall] + [float(v) for v in probe_vals])
        self.mass_csv.writerow([t, float(mdot), 0.0, f98, f2, 0.0])
        return f98, f2

    def save_frame(self, step, t, T, p, st):
        if self.dc is None or step % self.output_every:
            return
        host_sync(2)
        fields = {
            "temperature": T.cpu().numpy(), "pressure": p.cpu().numpy(),
            "tau": st.tau_elem, "rho_s": st.rho_elem,
            "pi_total": st.pi_elem, "m_dot_g": st.mdot_elem,
            "degree_char": st.degree_char_elem,
            "char_density_fraction": st.char_density_fraction_elem,
        }
        for r in range(self.mat.num_reactions):
            fields[f"X{r + 1}"] = st.extent_elem[r]
        self.dc.save(step, t, fields)

    def finish(self, totals, wall):
        _write_tolerances_csv(self.cfg, self.output_path)
        self.close(totals, wall)

    def close(self, totals, wall):
        """The timing summary, then every CSV stream closed."""
        _write_timing_summary(self.cfg, self.output_path, totals,
                              self.nsteps, wall)
        for w in self.csvs:
            w.close()

    def timing_row(self, step, rec):
        newton = sum(rec.get(k, 0.0) for k in ("residual", "jacobian",
                                               "factorization", "linear",
                                               "update"))
        rec["newton"] = newton
        rec["total"] = newton + sum(rec.get(k, 0.0)
                                    for k in ("bc", "state", "output"))
        self.timing_csv.writerow([
            step, rec.get("bc", 0.0), newton, rec.get("residual", 0.0),
            rec.get("jacobian", 0.0) + rec.get("factorization", 0.0),
            rec.get("linear", 0.0), rec.get("update", 0.0),
            rec.get("state", 0.0), rec.get("output", 0.0), rec["total"]])
        return rec

    # -- the eager loop's hooks (apps.ablation_loop) -------------------------

    def start(self):
        """(step, t, T, p, state) where the run starts: the initial
        fields."""
        T, p = self.initial_fields()
        state = self.initial_state()
        print(f"Time steps: {self.nsteps}, nominal final time: "
              f"{self.nsteps * self.dt}")
        return 0, 0.0, T, p, state

    def stepping(self, step, t):
        """Whether a step follows step ``step``: ``nsteps`` in all."""
        return step < self.nsteps

    def restart_writer(self, t0):
        """No checkpoints: (write, at_end) that do nothing."""
        nothing = lambda *args: None
        return nothing, nothing

    def boundary(self, t):
        """(wall temperature, no flux branch) of the step ending at t."""
        return evaluate_schedule(self.schedule, t), None

    def move_mesh(self, timer, T, p, state, t, dt, bnd):
        """Nothing moves before the solve: (state, no geometry)."""
        return state, None

    def step_args(self, s):
        """The arguments after (T, p) of ``residual`` and ``jacobians`` at
        step ``s`` (``ablation_loop.Step``)."""
        return s.T_old_q, s.p_old_q, s.X_old, s.dt

    def jacobians(self, T, p, T_old_q, p_old_q, X_old, dt, phase=None):
        """The element blocks, and no face blocks."""
        return self.sys.element_jacobians(T, p, T_old_q, p_old_q, X_old,
                                          dt), None

    def distributed(self, option, nranks):
        """The Newton iterate distributed over a world of ``nranks``
        (``apps.distributed``)."""
        return DistributedNewton(option, nranks, self.sys, self.ess_T,
                                 self.ess, self.cfg, self.device)

    def newton_instance(self, dn, s):
        """(instance, face bc) of step ``s``: the one instance, with its
        slabs of the step's old state; no face term."""
        inst = dn.get()
        dn.set_step(inst, s.T_old_q, s.p_old_q, s.X_old)
        return inst, None

    def geometry_kw(self, s):
        """The geometry of step ``s`` for ``jacobian_check``: the mesh's."""
        return {}

    def check_jacobians(self, T, p, s, step, tol, results):
        """``jacobian_check`` (``tol``: absolute, relative): the domain
        blocks at step 1, into ``results["domain"]``."""
        if step == 1:
            rel = results["domain"] = self.sys.jacobian_check(
                T, p, s.T_old_q, s.p_old_q, s.X_old, s.dt, abs_tol=tol[0],
                rel_tol=tol[1], **self.geometry_kw(s))
            print(f"jacobian_check (domain blocks) passed "
                  f"(max rel err {rel:.3e})")

    def write_outputs(self, step, t, T, p, state):
        """The probe and mass rows of time t and its ParaView frame."""
        host_sync()
        mdot = float(self.sys.top_boundary_mass_flux(T, p, state))
        host_sync()
        self.write_rows(t, self.probes(T).cpu().numpy(), mdot,
                        state.tau_elem)
        self.save_frame(step, t, T, p, state)

    def progress(self, step, t, bnd, iters, T, state):
        """The progress line of the first five steps, every 50th and the
        last."""
        if step <= 5 or step % 50 == 0 or step == self.nsteps:
            host_sync()
            print(f"step={step} t={t:g} newton_iters={iters} "
                  f"Tmax={float(torch.max(T)):.1f} "
                  f"tau_min={state.tau_elem.min():.4f}")

    def results(self, step, t, metrics):
        """The case's own keys of a run's result: none."""
        return {}


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    device = resolve_device(device)
    if cfg.get("scan_stepping", False):
        if int(cfg.get("sharding_devices", 0)) or \
                int(cfg.get("dof_partition", 0)):
            raise ValueError("scan_stepping is mutually exclusive with "
                             "sharding_devices / dof_partition")
        return run_scan(cfg, device=device, dtype=dtype)
    return run_on_ranks(__name__, _run, cfg, device, dtype)


def _run(cfg, device, dtype, option=None, nranks=0):
    return ablation_loop.run(Case1, cfg, device, dtype, option, nranks)


def run_scan(cfg: dict, device=None, dtype=torch.float64) -> dict:
    """Device-resident stepping (``scan_stepping: true``): BC schedule,
    per-step Newton (``scan_newton`` with ``make_scan_block_solver``'s
    solver), reaction-state advance and the probe/mass diagnostics stay on
    the device; the probe and mass rows and the Newton histories are read
    back once per ``output_every`` frame.  Same CSV schemas and ParaView
    cadence as the eager path."""
    from ..solvers.blocksolve import make_scan_block_solver

    device = resolve_device(device)
    run_t0 = _time.perf_counter()
    timer = StepTimer(sync=device_sync(device))
    with timer.span("run_setup"):
        c = Case1(cfg, device, dtype)
        sys_, ops, n = c.sys, c.ops, c.n
        newton_cfg = load_newton_config(cfg)
        lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
        bks = make_scan_block_solver(cfg, c.fes.element_dofs, n, c.ess,
                                     c.ess, c.fes.node_positions,
                                     device=device)
        print(f"scan_stepping: linear solver {type(bks).__name__}")
        t_edges = np.minimum(c.t_final, c.dt * np.arange(c.nsteps + 1))
        print(f"Time steps: {c.nsteps}, nominal final time: {t_edges[-1]}")

        T, p = c.initial_fields()
        state = c.initial_state()
        X = state.extent
        arrays = None
        c.write_rows(0.0, c.probes(T).cpu().numpy(),
                     sys_.top_boundary_mass_flux(T, p, state),
                     state.tau_elem)
        c.save_frame(0, 0.0, T, p, state)
    # the rows are the steps': what the set-up counted is dropped
    timer.step_reset()

    def residual(T, p, T_old_q, p_old_q, X, dt):
        with timer.phase("residual"):
            return c.residual(T, p, T_old_q, p_old_q, X, dt)

    def make_solve(T_old_q, p_old_q, X, dt, Tbc):
        def solve(T, p, R):
            with timer.phase("jacobian"):
                blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X, dt)
            with timer.phase("factorization"):
                fac = bks.prepare(blocks)
            with timer.phase("linear"):
                sol = bks.solve(fac, -R, rtol=lin_rtol)
            with timer.phase("update"):
                Tn, pn = c.enforce_bc(T + sol.x[:n], p + sol.x[n:], Tbc)
                un = torch.linalg.vector_norm(sol.x)
            krylov_step.append(sol.inner_iters)
            return Tn, pn, un, linear_usable(sol)
        return solve

    timing, newton_iters, krylov, frame = [], [], [], []
    stall_stats = NewtonStallStats()
    for step in range(1, c.nsteps + 1):
        with timer.span("step"):
            t = float(t_edges[step])
            dt = float(t_edges[step] - t_edges[step - 1])
            with timer.phase("state"):
                T_old_q = ops.values_at_qp(T)
                p_old_q = ops.values_at_qp(p)
            with timer.phase("bc"):
                Tbc = evaluate_schedule(c.schedule, t)
                T, p = c.enforce_bc(T, p, Tbc)
            krylov_step = []
            (T, p, it, r0, rn, done, res_h, upd_h, lin_ok,
             nw_stalled) = scan_newton(
                T, p,
                residual=lambda T, p: residual(T, p, T_old_q, p_old_q, X,
                                               dt),
                solve=make_solve(T_old_q, p_old_q, X, dt, Tbc),
                config=newton_cfg)
            if not lin_ok:
                raise RuntimeError(
                    f"block GMRES did not converge at step {step} "
                    "(raise gmres_restart/gmres_maxiter)")
            if not done:
                raise RuntimeError(f"Newton did not converge at step {step}"
                                   f", final residual={float(rn)}")
            with timer.phase("state"):
                arrays = sys_.advance_state_arrays(X, T, p, dt)
                X = arrays[0]
            with timer.phase("output"):
                frame.append((step, t, Tbc, c.probes(T),
                              sys_.top_boundary_mass_flux(T, p, X),
                              arrays[1], it, r0, rn, res_h, upd_h,
                              nw_stalled))
                if step % c.output_every == 0 or step == c.nsteps:
                    _flush_frame(c, frame, stall_stats)
                    frame = []
                    state = sys_.state_from_arrays(*arrays)
                    c.save_frame(step, t, T, p, state)
            rec = c.timing_row(step, timer.step_reset())
            timing.append(rec)
            newton_iters.append(it - 1)
            krylov.append(krylov_step)
        rec["step_wall"] = timer.spans["step"]

    with timer.span("run_finish"):
        if arrays is not None:
            state = sys_.state_from_arrays(*arrays)
        totals = {k: sum(r.get(k, 0.0) for r in timing)
                  for k in TIMING_KEYS + ("newton", "total")}
        c.finish(totals, _time.perf_counter() - run_t0)
        out = {"T": T.cpu().numpy(), "p": p.cpu().numpy(), "state": state,
               "fes": c.fes, "mesh": c.mesh, "converged": True,
               "timing": timing, "newton_iters": newton_iters,
               "krylov_iters": krylov, "linear_solver": type(bks).__name__,
               "newton_stall_stats": stall_stats.summary()}
        wall = totals["total"]
        print(f"scan_stepping: {c.nsteps} steps in {wall:.2f}s "
              f"({wall * 1e3 / max(1, c.nsteps):.1f} ms/step)")
    run_spans(timing, timer)
    return out


def _flush_frame(c, frame, stall_stats):
    """Read one output frame's per-step rows back from the device and write
    them to the CSVs."""
    host_sync(8)
    (probes, mdots, taus, r0s, rns, res_hs, upd_hs, stalls) = [
        torch.stack([f[k] for f in frame]).cpu().numpy()
        for k in (3, 4, 5, 7, 8, 9, 10, 11)]
    stall_stats.update(stalls, rns, r0s)
    if stalls.any():
        print(f"WARNING: {int(stalls.sum())}/{len(frame)} steps accepted at "
              "the Newton working-precision stall floor (not the abs/rel "
              "tolerance)", flush=True)
    for k, (step, t, *_, it, _, _, _, _, _) in enumerate(frame):
        c.write_rows(t, probes[k], mdots[k], taus[k])
        replay_newton_history(c.newton_csv, step, t, it, float(r0s[k]),
                              res_hs[k], upd_hs[k])


def main(argv=None):
    args = parse_args("Input/input_ablation_case1.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
