"""Ablation test case 2.2: surface recession on a moving mesh.

Port of ``cmfem_tpu/apps/ablation_case2_2.py`` (the reference's
ablation_test_case2_2_2D.cpp): case 2.1 plus char consumption
m_dot_c = rho_e u_e C_H B'c phi_blow with the coupled B'g + B'c blowing
fixed point, the recession velocity lumped to the top boundary, and PATO's
step order (recession BEFORE the solve):

  recession velocity -> Laplacian mesh velocity -> ALE extent remap ->
  mesh move + quality guard -> Newton on the moved mesh

with the ALE advective terms of the mesh velocity in the residual and,
with ``gcl_storage_enabled``, the storage terms in their Jacobian-weighted
form, J_old from the pre-move vertices.  The mass CSV carries the real
m_dot_c and the total recession; ALE checkpoints (version 2) carry the
receded vertices, the total recession and its history, with the JAX
package's keys and dtypes, so each package reads the other's checkpoints.

``run(cfg, device=None, dtype=torch.float64)``:

- the eager path keeps the vertices and the recession bookkeeping on the
  host (``MeshRecessionHandler``), smooths the mesh velocity with a
  cold-started CG on the device, remaps the extents on the host
  (``remap_extents_ale``), samples the probes with ``core.pointlocate``,
  and solves each Newton system with a host ``splu`` (``linear_solver:
  lu``) or the point-block GMRES on the device (``gmres``);
- ``scan_stepping: true`` (``run_scan``) keeps the state, the vertices and
  the smoothing velocity on the device: the recession velocity, the
  warm-started smoothing CG, the device remap (``make_scan_remap``), the
  move, ``scan_newton`` with ``make_scan_block_solver``'s solver, the
  state advance and the diagnostics through ``TrackedSampler`` (triangle
  strips only, as in the JAX package).  The JAX package fuses each output
  frame into one ``lax.scan`` program and chooses between moving and
  standing still with ``lax.cond``; here a host loop runs each step and
  branches on one read-back of max(v_rec) dt > 1e-16, and the diagnostics
  are read back once per output frame.

Float64 only. The eager path is ``apps.ablation_loop``'s loop over
``Case22``'s hooks. ``sharding_devices: N`` and ``dof_partition: N`` run it
on every rank of a world of N with the Newton iterate distributed
(``apps.distributed``; rank 0 writes the files), one instance per flux
branch whose geometry is refreshed after every mesh move; in a spawned world
the returned ``handler`` is None and tensors come back as numpy arrays. ``scan_stepping`` refuses both (the JAX
scan path refuses ``sharding_devices`` only and runs a ``dof_partition`` run
on one device). ``run`` returns the JAX driver's keys plus ``step``,
``converged``, ``timing`` (per step: recession, which the CSV's bc_sec
includes, then residual, jacobian, factorization, linear, update, state,
output, total seconds; on the eager path also the recession's phases
``recession_velocity``, ``mesh_velocity``, ``remap`` and ``mesh_move``,
which sum to it, ``face_jacobian``, the SEB face blocks inside
``jacobian``, ``step_wall``, the step's whole wall time, ``host_syncs``,
``mesh_cg_iters``, the smoother's CG iterations, and, as case 1's, the
first row's ``run_setup`` and the last row's ``run_finish``),
``newton_iters``, ``moved`` (per step: whether the mesh moved) and, with
``jacobian_check``, its results.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _time
from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from . import ablation_loop
from .ablation_case2_1 import RESTART_MAGIC, Case21, load_bprime_table
from .ablation_loop import TIMING_KEYS
from .common import (
    device_from_env, device_sync, echo_config, linear_usable,
    load_newton_config, moving_mesh_and_ale_toggles, parse_args,
    replay_newton_history, resolve_device, scan_newton, NewtonStallStats,
)
from ..core.tracksample import (TrackedSampler, front_depth_from_samples,
                                line_points)
from .distributed import DistributedNewton, run_on_ranks
from ..io import CsvWriter, writes_files
from ..motion.recession import (LaplacianSmoother, MeshRecessionHandler,
                                min_quality, quality_tables)
from ..motion.remap import make_scan_remap, remap_extents_ale
from ..utils.timing import StepTimer, host_copy, host_sync
from ..utils.yamlcfg import load_yaml, resolve_path

# ALE checkpoints carry the receded mesh (the reference's restart format
# does not, ablation_test_case2_1_2D.cpp:2666-2779, so a reference 2.2
# resume runs on the initial mesh).  Version 2: vertices, cumulative
# recession and the recession history round-trip.
RESTART_VERSION_ALE = 2

_MEQ_FIELDS = ("pi_total", "tau", "epsrho", "gradp_y", "rho_g",
               "mu_g", "K", "mobility", "mflux_y")
# the phases of the moving mesh before the solve; their sum is a row's
# ``recession``, which the CSV's bc_sec includes
RECESSION_PHASES = ("recession_velocity", "mesh_velocity", "remap",
                    "mesh_move")
_BOUNDARY_KEYS = (
    "m_dot_g_surf", "m_dot_c_surf", "rho_s_surf", "BprimeG_surf",
    "BprimeC_surf", "h_w_surf", "emissivity_surf", "absorptivity_surf",
    "reflectivity_surf", "blowing_correction_surf", "q_conv_surf",
    "q_adv_pyro_surf", "q_rad_emit_surf", "q_rad_abs_surf", "q_surf")


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_restart_ale(path, step, time, T, p, extent, vertices,
                     recession_total, recession_history, world_size=1,
                     elem_order="file"):
    """Write an ALE checkpoint (numpy arrays or tensors on any device); a
    rank that writes no files (``io.output``) writes nothing."""
    if not writes_files():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, magic=np.uint64(RESTART_MAGIC),
             version=np.uint32(RESTART_VERSION_ALE),
             world_size=np.int32(world_size),
             elem_order=np.str_(elem_order),
             step=np.int64(step), time=np.float64(time),
             T=_host(T), p=_host(p), extent=_host(extent),
             vertices=np.asarray(_host(vertices), dtype=np.float64),
             recession_total=np.float64(recession_total),
             recession_history=np.asarray(recession_history,
                                          dtype=np.float64).reshape(-1, 2))


def load_restart_ale(path, n, ne, nq, nr, nverts, dim, world_size=1,
                     elem_order="file"):
    """(step, time, T, p, extent, vertices, recession_total,
    recession_history) of an ALE checkpoint, as numpy arrays and floats;
    raises ValueError on a wrong magic, version, world size, element
    ordering or shape."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as d:
        if int(d["magic"]) != RESTART_MAGIC:
            raise ValueError(f"Invalid restart checkpoint magic in: {path}")
        if int(d["version"]) != RESTART_VERSION_ALE:
            raise ValueError(
                f"Unsupported ALE restart checkpoint version in: {path} "
                f"(file={int(d['version'])}, expected {RESTART_VERSION_ALE}).")
        if int(d["world_size"]) != world_size:
            raise ValueError(
                f"Restart checkpoint world size mismatch for {path} "
                f"(file={int(d['world_size'])}, run={world_size}).")
        file_order = str(d["elem_order"]) if "elem_order" in d else "file"
        if file_order != elem_order:
            raise ValueError(
                f"Restart element-order mismatch for {path}: checkpoint "
                f"was written with elem_order={file_order!r} but this run "
                f"uses {elem_order!r} (toggle 'lattice_residual' to match).")
        T = d["T"]; p = d["p"]; X = d["extent"]; V = d["vertices"]
        if len(T) != n or len(p) != n:
            raise ValueError(f"Restart true-dof size mismatch in: {path}")
        if X.shape != (ne, nq, nr):
            raise ValueError(f"Restart reaction-state shape mismatch in: {path}")
        if V.shape != (nverts, dim):
            raise ValueError(f"Restart mesh vertex shape mismatch in: {path}")
        return (int(d["step"]), float(d["time"]), T, p, X, V,
                float(d["recession_total"]),
                [(float(a), float(b)) for a, b in d["recession_history"]])


def _make_case22_csvs(cfg, output_path, probe_y):
    """The driver's eight CSV streams (shared by the eager and scan
    paths)."""
    path = lambda key, default: os.path.join(output_path,
                                             cfg.get(key, default))
    tags = ["wall"] + [f"TC{i}" for i in range(1, len(probe_y))]
    return {
        "probes": CsvWriter(path("probes_csv", "temperature_probes.csv"),
                            ["time"] + tags),
        "mass": CsvWriter(path("mass_csv", "mass_metrics.csv"),
                          ["time", "m_dot_g_surf", "m_dot_c",
                           "front_98_virgin", "front_2_char", "recession"]),
        "boundary": CsvWriter(path("boundary_csv",
                                   "boundary_diagnostics.csv"),
                              ["time"] + list(_BOUNDARY_KEYS)),
        "newton": CsvWriter(
            path("newton_csv", "newton_history_ablation_case2_2_2D.csv"),
            ["step", "time", "iter", "residual", "residual0", "rel_residual",
             "update_norm", "update0", "rel_update", "converged"]),
        # the study variant's pressure-probe and mesh-diagnostics streams
        "pressure": CsvWriter(
            path("pressure_csv", "pressure_probes.csv"),
            ["time", "wall"] + [f"PC{i}" for i in range(1, len(probe_y))]),
        "meshdiag": CsvWriter(path("mesh_csv", "mesh_diagnostics.csv"),
                              ["time", "y_top", "min_quality_ratio",
                               "max_node_disp", "total_recession"]),
        # per-point mass-equation diagnostics (the study variant's
        # mass_eq_probe_diagnostics stream,
        # ablation_test_case2_2_2D_test.cpp:4577-4601: 9 fields per tag)
        "masseq": CsvWriter(
            path("mass_eq_probe_csv", "mass_eq_probe_diagnostics.csv"),
            ["time"] + [f"{f}_{tag}" for tag in tags for f in _MEQ_FIELDS]),
        # per-step phase timing (case 1/2.1's schema; the pre-solve
        # recession and remap are folded into bc_sec)
        "timing": CsvWriter(
            path("timing_step_csv", "driver_timing_per_step.csv"),
            ["step", "bc_sec", "newton_sec", "newton_residual_eval_sec",
             "newton_jacobian_sec", "newton_linear_sec",
             "newton_update_sec", "state_advance_sec", "output_sec",
             "step_total_sec"]),
    }


def _finalize_case22_outputs(cfg, output_path, amaryllis_mass_file,
                             recession_history):
    """The recession comparison against an Amaryllis mass history
    (AmaryllisRecessionHistory and the recession error metrics,
    ablation_test_case2_2_2D_test.cpp:302-460) and the acceptance
    tolerance echo; shared by the eager and scan paths."""
    recession_metrics = None
    am_path = resolve_path(cfg, amaryllis_mass_file) if amaryllis_mass_file \
        else ""
    if am_path and os.path.isfile(am_path):
        am = np.loadtxt(am_path, comments="//", ndmin=2)
        if am.shape[1] >= 6 and len(am):
            th = np.array([r[0] for r in recession_history])
            rh = np.array([r[1] for r in recession_history])
            ref_r = np.maximum(0.0, np.interp(th, am[:, 0], am[:, 5]))
            err = rh - ref_r
            recession_metrics = {
                "rmse": float(np.sqrt(np.mean(err ** 2))),
                "max_abs": float(np.abs(err).max()),
                "final_abs": float(abs(err[-1])),
                "final_rel": float(abs(err[-1])
                                   / max(abs(ref_r[-1]), 1e-12)),
            }
            with CsvWriter(os.path.join(output_path,
                                        "recession_error_metrics.csv"),
                           ["metric", "value"]) as w:
                for k, v in recession_metrics.items():
                    w.writerow([k, v])
            print(f"Recession vs Amaryllis: rmse={recession_metrics['rmse']:.4e}"
                  f" final_rel={recession_metrics['final_rel']:.4e}")

    acc = cfg.get("acceptance", {})
    with CsvWriter(os.path.join(output_path, "amaryllis_error_tolerances.csv"),
                   ["signal", "tolerance"]) as w:
        for key, default in (
                ("temperature_rmse_max", 300.0),
                ("temperature_max_abs_max", 650.0),
                ("m_dot_g_rmse_max", 0.025), ("m_dot_g_max_abs_max", 0.08),
                ("m_dot_c_rmse_max", 0.01),
                ("m_dot_c_peak_rel_error_max", 0.35),
                ("recession_rmse_max", 0.0015),
                ("recession_final_rel_error_max", 0.12)):
            w.writerow([key, float(acc.get(key, default))])
    return recession_metrics


class StepGeometry(NamedTuple):
    """The moved mesh a step's Newton solve runs on: vertices (a tensor),
    their geometric factors, the mesh velocity at the QPs and the GCL pair
    (J_old, J_new) or None."""
    verts: torch.Tensor
    gf: object
    wq: torch.Tensor
    gcl: tuple | None


class Case22(Case21):
    """The set-up of a case-2.2 run: case 2.1's (mesh, deck, space, system,
    B' table, schedule, host LU) with the case-2.2 flux model (coupled
    B'g + B'c blowing), the mesh-motion options, the eight CSV streams and
    the ALE checkpoints."""

    NAME = "ablation_case2_2"
    NEWTON_PRINT_MULTILINE = False
    DEFAULTS = {"material_file": "Input/material_tacot_case2_2.yaml",
                "output_path": "ParaView/ablation_case2_2",
                "collection_name": "ablation_test_case2_2_2D",
                "probe_y": [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034,
                            0.026, 0.0]}

    def __init__(self, cfg, device, dtype):
        super().__init__(cfg, device, dtype)
        self.bdr_bottom = int(cfg.get("bdr_attr_bottom", 2))
        self.density_mode = cfg.get("recession_density_mode", "char_surface")
        self.density_constant = float(cfg.get("recession_density_constant",
                                              1200.0))
        self.max_step_recession = float(cfg.get("max_step_recession",
                                                float("inf")))
        self.min_quality_ratio = float(cfg.get("min_quality_ratio", 0.05))
        self.recession_enabled, self.ale_toggles = \
            moving_mesh_and_ale_toggles(cfg)
        self.gcl_enabled = bool(cfg.get("gcl_storage_enabled", False))
        self.amaryllis_mass_file = cfg.get("amaryllis_mass_file", "")
        self.probe_pts = np.array([[self.probe_x, y]
                                   for y in self.probe_y[1:]])
        self.top_dofs = np.asarray(self.fes.boundary_dofs([self.bdr_top]))
        self.top_t = torch.as_tensor(self.top_dofs, device=device)
        # the handler's state while a run steps (the eager path's)
        self.rec = None
        self.recession_total = 0.0
        self.recession_history = [(0.0, 0.0)]
        self.last_max_disp, self.last_quality_ratio = 0.0, 1.0
        self.moved = []

    def _init_boundary(self, cfg):
        from ..physics.seb import SurfaceFluxModel
        from ..physics.surface_bc import SurfaceBCSchedule

        self.use_dirichlet = False
        self.top_T_sched = None
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
            strict_case2_2=bool(cfg.get("strict_case2_2", False)),
            pato_compat_mode="off" if compat is False else str(compat).lower(),
            case22=True)
        self.bprime = load_bprime_table(cfg)
        self.schedule = SurfaceBCSchedule.load_file(resolve_path(
            cfg, cfg.get("boundary_conditions_file",
                         "Input/boundary_conditions_ablation_case2_2.dat")))

    def _make_csvs(self):
        self.csv = _make_case22_csvs(self.cfg, self.output_path,
                                     self.probe_y)
        self.newton_csv = self.csv["newton"]
        self.timing_csv = self.csv["timing"]
        self.csvs = list(self.csv.values())

    # -- the moving mesh -------------------------------------------------

    def make_handler(self):
        """The eager path's ``MeshRecessionHandler`` (None without mesh
        motion)."""
        if self.recession_enabled:
            self.rec = MeshRecessionHandler(
                self.mesh, self.fes, bdr_attr_top=self.bdr_top,
                bdr_attr_bottom=self.bdr_bottom,
                max_step_recession=self.max_step_recession,
                min_quality_ratio=self.min_quality_ratio,
                device=self.device, dtype=self.dtype)
        return self.rec

    def vertices(self):
        """The current vertices (numpy)."""
        return self.rec.vertices if self.rec is not None \
            else np.asarray(self.mesh.vertices, dtype=np.float64)

    def geometry(self, verts, wq=None, J_old=None):
        """The ``StepGeometry`` of vertex tensor ``verts``; ``J_old`` is
        the pre-move detJ (the GCL pair is formed when the run stores
        GCL)."""
        gf = self.ops.geometric_factors(verts)
        if wq is None:
            wq = torch.zeros(gf.xq.shape, dtype=self.dtype,
                             device=self.device)
        gcl = (J_old, gf.detJ) if self.gcl_enabled else None
        return StepGeometry(verts, gf, wq, gcl)

    # -- the step's residual and Jacobians on the moved mesh ---------------

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, bc, branch, g):
        RT, Rp = self.sys.residual(T, p, T_old_q, p_old_q, X_old, dt,
                                   gf=g.gf, wq=g.wq, gcl=g.gcl,
                                   ale_toggles=self.ale_toggles)
        RT = RT + self.sys.seb_face_residual(T, p, X_old, bc,
                                             *self.seb(branch),
                                             vertices=g.verts)
        return torch.where(self.mask2_t, 0.0, torch.cat([RT, Rp]))

    def jacobians(self, T, p, T_old_q, p_old_q, X_old, dt, bc, branch, g,
                  phase=None):
        """The element blocks and the SEB face blocks; ``phase`` (a
        ``StepTimer.phase``) times the face blocks as ``face_jacobian``."""
        blocks = self.sys.element_jacobians(T, p, T_old_q, p_old_q, X_old,
                                            dt, gf=g.gf, wq=g.wq, gcl=g.gcl,
                                            ale_toggles=self.ale_toggles)
        with phase("face_jacobian") if phase else nullcontext():
            face = self.sys.seb_face_jacobians(T, p, X_old, bc,
                                               *self.seb(branch),
                                               vertices=g.verts)
        return blocks, face

    # -- outputs ---------------------------------------------------------

    def write_step_rows(self, t, T, p, state, v, branch_bc, last_max_disp,
                        min_quality_ratio):
        """One output time's rows from host sampling on the vertices ``v``
        (numpy): the eager path's ``_write_case22_step_outputs``."""
        from ..core.pointlocate import front_depth, sample_h1_fields

        bc, branch = branch_bc
        lo, hi = v.min(axis=0), v.max(axis=0)
        xmid = 0.5 * (lo[0] + hi[0])
        # the wall probe tracks the LOCAL surface at probe_x (interpolated
        # from the bracketing top-edge nodes); one location pass covers
        # the wall and probe points for T and p
        top_w = np.unique(np.asarray(self.sys.trace.fes.bdr.dofs)
                          [self.sys.trace.face_ids])
        tx = v[top_w, 0]
        srt = np.argsort(tx)
        j = int(np.clip(np.searchsorted(tx[srt], self.probe_x), 1,
                        len(srt) - 1))
        den = tx[srt[j]] - tx[srt[j - 1]]
        w_ = float((self.probe_x - tx[srt[j - 1]]) / den) if den > 0 else 0.0
        wall_y = ((1.0 - w_) * v[top_w[srt[j - 1]], 1]
                  + w_ * v[top_w[srt[j]], 1])
        wall_pt = np.array([[self.probe_x, min(self.probe_y[0],
                                               wall_y - 1e-9)]])
        pts_all = np.vstack([wall_pt, self.probe_pts])
        Th, ph = _host(T), _host(p)
        Ts, ps = sample_h1_fields(self.fes, [Th, ph], pts_all, vertices=v)
        bdiag = self.sys.top_boundary_diagnostics(
            T, p, state, bc, *self.seb(branch), vertices=v)
        f98, f2 = (front_depth(self.mesh, state.tau_elem, xmid, hi[1], lo[1],
                               thr, vertices=v) for thr in (0.98, 0.02))
        meq = self.sys.mass_eq_probe(Th, ph, state, pts_all, vertices=v)
        self._write_rows(t, Ts, ps, meq, bdiag, f98, f2, float(hi[1]),
                         min_quality_ratio, last_max_disp,
                         self.recession_total)

    def _write_rows(self, t, Ts, ps, meq, bdiag, f98, f2, top_y, qratio,
                    max_disp, rec_total):
        csv = self.csv
        csv["probes"].writerow([t] + [float(x) for x in Ts])
        csv["pressure"].writerow([t] + [float(x) for x in ps])
        csv["meshdiag"].writerow([t, top_y, qratio, max_disp, rec_total])
        csv["masseq"].writerow([t] + [float(x) for x in
                                      np.asarray(meq).reshape(-1)])
        csv["mass"].writerow([t, bdiag["m_dot_g_surf"],
                              bdiag["m_dot_c_surf"], f98, f2, rec_total])
        csv["boundary"].writerow([t] + [bdiag[k] for k in _BOUNDARY_KEYS])

    def save_frame(self, step, t, T, p, st, vertices=None, extra=None):
        if self.dc is None or step % self.output_every:
            return
        fields = {
            "temperature": _host(T), "pressure": _host(p),
            "tau": st.tau_elem, "rho_s": st.rho_elem,
            "pi_total": st.pi_elem, "m_dot_g": st.mdot_elem,
            "degree_char": st.degree_char_elem,
            "char_density_fraction": st.char_density_fraction_elem,
        }
        for r in range(self.mat.num_reactions):
            fields[f"X{r + 1}"] = st.extent_elem[r]
        fields.update(extra or {})
        self.dc.save(step, t, fields, vertices=vertices)

    def timing_row(self, step, rec):
        # the eager path's recession is its four phases, the scan path's
        # one; the CSV's bc_sec holds it, as the JAX driver's
        rec.setdefault("recession", sum(rec.get(k, 0.0)
                                        for k in RECESSION_PHASES))
        rec["bc"] = rec.get("bc", 0.0) + rec["recession"]
        return super().timing_row(step, rec)

    def finish(self, totals, wall):
        metrics = _finalize_case22_outputs(self.cfg, self.output_path,
                                           self.amaryllis_mass_file,
                                           self.recession_history)
        self.close(totals, wall)
        return metrics

    # -- restart ---------------------------------------------------------

    def load_restart(self):
        """(step, t, T, p, state) from ``restart_read_file``, or None; the
        handler is restored to the checkpoint's vertices and recession."""
        path = self.cfg.get("restart_read_file", "")
        if not path:
            return None
        sys_ = self.sys
        (step, t, T, p, X, V, self.recession_total,
         self.recession_history) = load_restart_ale(
            resolve_path(self.cfg, path), self.n, sys_.ne, sys_.nq,
            self.mat.num_reactions, self.mesh.vertices.shape[0],
            self.mesh.dim, elem_order=self.elem_order)
        tens = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        T, p = tens(T), tens(p)
        state = sys_.advance_state(
            dataclasses.replace(self.initial_state(), extent=tens(X)), T, p,
            0.0)
        if self.rec is not None:
            self.rec.restore(V, self.recession_total)
        print(f"Loaded ALE restart from {path} at step {step}, time {t} s "
              f"(recession {self.recession_total:.3e} m).")
        return step, t, T, p, state

    def save_checkpoint(self, path, step, t, T, p, X):
        save_restart_ale(path, step, t, T, p, X, self.vertices(),
                         self.recession_total, self.recession_history,
                         elem_order=self.elem_order)

    # -- the eager loop's hooks (apps.ablation_loop) -------------------------

    def start(self):
        """Case 2.1's start, the mesh handler made first (a checkpoint
        restores it)."""
        self.make_handler()
        return super().start()

    def move_mesh(self, timer, T, p, state, t, dt, bnd):
        """PATO's order, before the solve: the recession velocity, the
        Laplacian mesh velocity, the ALE remap of the extents and the move,
        each a phase (their sum is the row's ``recession``); records the
        move and (t, total recession).  (state with the remapped extents,
        the step's ``StepGeometry``)."""
        ops, rec = self.ops, self.rec
        bc, branch = bnd
        wq = None
        with timer.phase("recession_velocity"):
            J_old = ops.geometric_factors(self.vertices()).detJ \
                if self.gcl_enabled else None
            if rec is not None:
                v_top = self.sys.top_boundary_recession_velocity(
                    T, p, state, bc, branch, self.model, self.bprime,
                    recession_density_mode=self.density_mode,
                    recession_density_constant=self.density_constant,
                    vertices=rec.vertices)
        with timer.phase("mesh_velocity"):
            if rec is not None:
                rec.prepare_advance(v_top, dt)
        with timer.phase("remap"):
            if rec is not None:
                X_new = remap_extents_ale(
                    self.mesh, ops, state.extent,
                    rec.mesh_velocity_at_qp(ops), dt, rec.vertices)
                host_copy(X_new, self.device)
                state = dataclasses.replace(state, extent=torch.as_tensor(
                    X_new, dtype=self.dtype, device=self.device))
        with timer.phase("mesh_move"):
            if rec is not None:
                out = rec.commit_advance()
                self.recession_total = out["total_recession"]
                self.last_max_disp = out["max_node_disp"]
                self.last_quality_ratio = out["min_quality"]
                wq = rec.mesh_velocity_at_qp(ops)
            self.moved.append(rec is not None and out["delta_recession"] > 0)
            g = self.geometry(ops._vertices(self.vertices()), wq, J_old)
        self.recession_history.append((t, self.recession_total))
        return state, g

    def step_args(self, s):
        return super().step_args(s) + (s.g,)

    def distributed(self, option, nranks):
        """Case 1's, with the ALE terms and the GCL storage."""
        return DistributedNewton(option, nranks, self.sys, self.ess_T,
                                 self.ess, self.cfg, self.device,
                                 ale_toggles=self.ale_toggles,
                                 gcl_enabled=self.gcl_enabled)

    def newton_instance(self, dn, s):
        """(instance, face bc) of step ``s``: the flux branch's instance on
        the moved geometry, with its slabs of the step's old state and ALE
        terms."""
        bc, branch = s.bnd
        inst = dn.get(branch, seb=self.seb(branch))
        inst.update_geometry(s.g.verts)
        dn.set_step(inst, s.T_old_q, s.p_old_q, s.X_old, wq=s.g.wq,
                    gcl=s.g.gcl)
        return inst, bc

    def geometry_kw(self, s):
        """The moved mesh of step ``s``: its factors, mesh velocity, GCL
        pair and vertices, and the ALE switches."""
        g = s.g
        return dict(gf=g.gf, wq=g.wq, gcl=g.gcl,
                    ale_toggles=self.ale_toggles, vertices=g.verts)

    def write_outputs(self, step, t, T, p, state):
        """The rows of time t sampled on the current vertices and its
        ParaView frame (with the mesh velocity and the recession on a
        moving mesh)."""
        v = self.vertices()
        self.write_step_rows(t, T, p, state, v, self.boundary(t),
                             self.last_max_disp, self.last_quality_ratio)
        extra = {} if self.rec is None else {
            "mesh_velocity": self.rec.mesh_velocity,
            "recession": np.full(self.n, self.recession_total)}
        self.save_frame(step, t, T, p, state, vertices=v, extra=extra)

    def progress(self, step, t, bnd, iters, T, state):
        """The progress line of the first five steps and every 50th."""
        if step <= 5 or step % 50 == 0:
            host_sync()
            print(f"step={step} t={t:g} [{bnd[1]}] newton_iters={iters} "
                  f"Tmax={float(torch.max(T)):.1f} "
                  f"recession={self.recession_total:.3e}")

    def results(self, step, t, metrics):
        return {**super().results(step, t, metrics),
                "recession_total": self.recession_total,
                "vertices": self.vertices().copy(), "handler": self.rec,
                "recession_history": self.recession_history,
                "recession_metrics": metrics, "moved": self.moved}


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    device = resolve_device(device)
    if cfg.get("scan_stepping", False):
        return run_scan(cfg, device=device, dtype=dtype)
    return run_on_ranks(__name__, _run, cfg, device, dtype)


def _run(cfg, device, dtype, option=None, nranks=0):
    return ablation_loop.run(Case22, cfg, device, dtype, option, nranks)


class ScanMotion:
    """The scan path's device mesh motion and diagnostics: the recession
    velocity, the warm-started Laplacian smoothing, the device remap, the
    quality metric and the tracked-candidate sampling of every CSV stream
    (``step_diagnostics``), with no read-back."""

    def __init__(self, c: Case22, nsteps):
        self.c = c
        dev, dtype = c.device, c.dtype
        mesh, fes = c.mesh, c.fes
        self.verts0 = np.asarray(mesh.vertices, dtype=np.float64)
        self.smoother = LaplacianSmoother(
            fes, c.top_dofs, np.asarray(fes.boundary_dofs([c.bdr_bottom])),
            device=dev, dtype=dtype)
        self.qual = quality_tables(mesh, dev, dtype)
        self.init_minq = float(self.min_quality(self.tensor(self.verts0)))
        if not np.isfinite(self.init_minq) or self.init_minq <= 0:
            raise RuntimeError(
                "Invalid initial mesh quality for moving-mesh recession.")
        self.remap = make_scan_remap(mesh, c.ops) \
            if c.recession_enabled else None
        self.vmax = (c.max_step_recession / c.dt) \
            if (np.isfinite(c.max_step_recession)
                and c.max_step_recession > 0 and c.dt > 0) else np.inf

        # the candidate band of the tracked samplers covers the total
        # motion of the run: the recession bound max_step_recession *
        # nsteps, capped at the strip height (recession beyond the full
        # height consumes the domain anyway)
        v0lo, v0hi = self.verts0.min(axis=0), self.verts0.max(axis=0)
        height0 = float(v0hi[1] - v0lo[1])
        rec_bound = (c.max_step_recession * nsteps
                     if (np.isfinite(c.max_step_recession)
                         and c.max_step_recession > 0) else height0)
        self.slack = float(min(height0, max(2.0e-3, 1.25 * rec_bound)))
        # row 0 is the wall probe: its y follows the LOCAL receding
        # surface at probe_x.  x never changes under the y-only smoothing,
        # so the bracketing top-edge nodes are static and their current
        # heights interpolate the local wall height exactly (P1 top edge).
        pts_all0 = np.vstack([[[c.probe_x, min(c.probe_y[0],
                                               v0hi[1] - 1e-9)]],
                              c.probe_pts])
        tx = self.verts0[c.top_dofs, 0]
        order = np.argsort(tx)
        j = int(np.clip(np.searchsorted(tx[order], c.probe_x), 1,
                        len(order) - 1))
        self.wall_n0 = int(c.top_dofs[order[j - 1]])
        self.wall_n1 = int(c.top_dofs[order[j]])
        den = tx[order[j]] - tx[order[j - 1]]
        self.wall_w = float((c.probe_x - tx[order[j - 1]]) / den) \
            if den > 0 else 0.0
        self.diag_sampler = TrackedSampler(mesh, pts_all0,
                                           y_slack=self.slack, device=dev,
                                           dtype=dtype)
        self.pts_all0 = self.tensor(pts_all0)
        line_pts = line_points(0.5 * (v0lo[0] + v0hi[0]), v0hi[1], v0lo[1])
        self.line_sampler = TrackedSampler(mesh, line_pts,
                                           y_slack=self.slack, device=dev,
                                           dtype=dtype)
        self.line_ys = self.tensor(line_pts[:, 1])

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.c.dtype,
                               device=self.c.device)

    def min_quality(self, verts):
        return min_quality(self.qual, verts)

    def velocity(self, T, p, X, bc, branch, verts):
        """The clamped top recession velocity (n,) and its mean over the
        top DOFs (0-d tensors)."""
        c = self.c
        Xrep = torch.mean(X, dim=1)[c.sys._trace_elem]
        v_rec = c.sys._recession_velocity_terms(
            T, p, Xrep, bc, branch, c.model, c.bprime, c.density_mode,
            c.density_constant, verts)
        v_rec = torch.minimum(v_rec, torch.full_like(v_rec, self.vmax))
        mean_v = torch.mean(v_rec[c.top_t]) if len(c.top_dofs) \
            else torch.zeros((), dtype=v_rec.dtype, device=v_rec.device)
        return v_rec, mean_v

    def move(self, X, verts, rec_total, wy_prev, v_rec, mean_v, dt):
        """The JAX path's ``_move``: (X, verts, rec_total, wy, wq,
        max_disp, J_pre) after smoothing from the warm start ``wy_prev``,
        remapping and moving."""
        c = self.c
        ops = c.ops
        wy = self.smoother.solve(verts, v_rec, x0=wy_prev).x
        w_nodal = torch.zeros((c.n, c.mesh.dim), dtype=c.dtype,
                              device=c.device)
        w_nodal[:, 1] = wy
        gf_pre = ops.geometric_factors(verts)
        wq = torch.einsum("qn,end->eqd", ops.B, w_nodal[ops.eldofs])
        Xn = self.remap(X, verts, gf_pre.xq, wq, dt)
        # order-1 nodal mesh: scalar dofs == vertices
        disp = dt * w_nodal
        return (Xn, verts + disp, rec_total + mean_v * dt, wy, wq,
                torch.abs(disp).max(), gf_pre.detJ)

    def still(self, X, verts, rec_total, wy_prev):
        """The JAX path's ``_still``: nothing moves, the warm start is
        reset."""
        c = self.c
        gf = c.ops.geometric_factors(verts)
        return (X, verts, rec_total, torch.zeros_like(wy_prev),
                torch.zeros(gf.xq.shape, dtype=c.dtype, device=c.device),
                torch.zeros((), dtype=c.dtype, device=c.device), gf.detJ)

    def step_diagnostics(self, T, p, X, pi_qp, tau_e, verts, bc, branch):
        """One step's CSV quantities on the device, stacked:
        (T at the wall + probes (np,), p there (np,), the mass-equation
        probes (np, 9), the boundary values (``top_boundary_values``),
        [f98, f2, top_y])."""
        c = self.c
        top_y = torch.max(verts[c.top_t, 1])
        wall_y = ((1.0 - self.wall_w) * verts[self.wall_n0, 1]
                  + self.wall_w * verts[self.wall_n1, 1])
        pts = self.pts_all0.clone()
        pts[0, 1] = torch.minimum(self.pts_all0[0, 1], wall_y - 1e-9)
        s = self.diag_sampler
        loc = s.locate(verts, pts)
        Ts = s.sample_h1(loc, T)
        ps = s.sample_h1(loc, p)
        meq = c.sys.mass_eq_probe_scan(T, p, X, pi_qp, s, loc, verts)
        bvals = c.sys.top_boundary_values(T, p, X, bc, *c.seb(branch),
                                          vertices=verts)
        lvals = self.line_sampler.sample_l2(self.line_sampler.locate(verts),
                                            tau_e)
        fronts = torch.stack([
            front_depth_from_samples(lvals, self.line_ys, top_y, 0.98),
            front_depth_from_samples(lvals, self.line_ys, top_y, 0.02),
            top_y])
        return Ts, ps, meq, bvals, fronts


def run_scan(cfg: dict, device=None, dtype=torch.float64) -> dict:
    """Device-resident stepping (``scan_stepping: true``): the recession,
    the warm-started smoothing, the device remap, the move, the Newton
    solve, the state advance and the diagnostics stay on the device; the
    CSV rows and the Newton histories are read back once per
    ``output_every`` frame.  Order-1 triangle strips (the tracked
    samplers'), no restart I/O, no ``jacobian_check``."""
    from ..solvers.blocksolve import make_scan_block_solver

    device = resolve_device(device)
    if int(cfg.get("order", 1)) != 1:
        raise NotImplementedError("scan_stepping requires order 1")
    if int(cfg.get("sharding_devices", 0)):
        raise NotImplementedError(
            "scan_stepping and sharding_devices are mutually exclusive")
    if int(cfg.get("dof_partition", 0)):
        # the JAX scan path ignores this option and runs on one device;
        # a run on fewer ranks than asked is refused here instead
        raise NotImplementedError(
            "scan_stepping and dof_partition are mutually exclusive")
    if cfg.get("restart_read_file", "") or cfg.get("restart_write_file", ""):
        raise NotImplementedError(
            "scan_stepping does not support restart I/O; use the eager path")
    if bool(cfg.get("jacobian_check", False)):
        raise NotImplementedError(
            "jacobian_check is host-side; use the eager path")
    run_t0 = _time.perf_counter()
    c = Case22(cfg, device, dtype)
    sys_, ops, n = c.sys, c.ops, c.n
    newton_cfg = load_newton_config(cfg)
    lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
    bks = make_scan_block_solver(cfg, c.fes.element_dofs, n, c.ess_T, c.ess,
                                 c.fes.node_positions, device=device)
    print(f"scan_stepping: linear solver {type(bks).__name__}")
    t_edges = np.minimum(c.t_final, c.dt * np.arange(c.nsteps + 1))
    print(f"Time steps: {c.nsteps}, nominal final time: {t_edges[-1]}")
    m = ScanMotion(c, c.nsteps)
    timer = StepTimer(sync=device_sync(device))

    T, p = c.initial_fields()
    state0 = c.initial_state()
    X = state0.extent
    verts = m.tensor(m.verts0)
    rec_total = torch.zeros((), dtype=dtype, device=device)
    wy_prev = torch.zeros(n, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    pi_qp = m.tensor(state0.pi_qp)
    bc0, branch0 = c.boundary(0.0)
    diag0 = m.step_diagnostics(T, p, X, pi_qp, m.tensor(state0.tau_elem),
                               verts, bc0, branch0)
    frame = [(0, 0.0, diag0, torch.stack([rec_total, zero, m.init_minq
                                          + zero]), None)]
    _flush_scan_frame(c, m, frame, NewtonStallStats())
    c.save_frame(0, 0.0, T, p, state0, vertices=m.verts0,
                 extra=({"recession": np.zeros(n)} if c.recession_enabled
                        else {}))

    def make_solve(T_old_q, p_old_q, X, dt, bc, branch, t, g):
        def solve(T, p, R):
            with timer.phase("jacobian"):
                blocks, face = c.jacobians(T, p, T_old_q, p_old_q, X, dt,
                                           bc, branch, g)
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

    def residual(*args):
        with timer.phase("residual"):
            return c.residual(*args)

    timing, newton_iters, krylov, moved, frame = [], [], [], [], []
    stall_stats = NewtonStallStats()
    arrays = None
    for k in range(1, c.nsteps + 1):
        t, dt = float(t_edges[k]), float(t_edges[k] - t_edges[k - 1])
        bc, branch = c.boundary(t)
        # -- recession (PATO's order: before the solve) --------------------
        with timer.phase("recession"):
            if c.recession_enabled:
                v_rec, mean_v = m.velocity(T, p, X, bc, branch, verts)
                # skip the smoothing, remap and move while the surface is
                # not receding (the JAX path's lax.cond): one read-back
                active = bool(torch.max(v_rec) * dt > 1e-16)
                (X, verts, rec_total, wy_prev, wq, max_disp, J_pre) = (
                    m.move(X, verts, rec_total, wy_prev, v_rec, mean_v, dt)
                    if active else m.still(X, verts, rec_total, wy_prev))
            else:
                active, wq, mean_v, max_disp = False, None, zero, zero
                J_pre = ops.geometric_factors(verts).detJ
            moved.append(active)
            minq = m.min_quality(verts)
            g = c.geometry(verts, wq, J_pre)
        with timer.phase("state"):
            T_old_q = ops.values_at_qp(T)
            p_old_q = ops.values_at_qp(p)
        with timer.phase("bc"):
            T, p = c.enforce_bc(T, p, bc, t)
        krylov_step = []
        args = (T_old_q, p_old_q, X, dt, bc, branch, g)
        (T, p, it, r0, rn, done, res_h, upd_h, lin_ok,
         nw_stalled) = scan_newton(
            T, p, residual=lambda T, p: residual(T, p, *args),
            solve=make_solve(*args[:-1], t, g), config=newton_cfg)
        if not lin_ok:
            raise RuntimeError(
                f"block GMRES did not converge at step {k} "
                "(raise gmres_restart/gmres_maxiter)")
        if not done:
            raise RuntimeError(f"Newton did not converge at step {k}, "
                               f"final residual={float(rn)}")
        with timer.phase("state"):
            arrays = sys_.advance_state_arrays(X, T, p, dt)
            X = arrays[0]
        with timer.phase("output"):
            diag = m.step_diagnostics(T, p, X, arrays[6], arrays[1], verts,
                                      bc, branch)
            frame.append((k, t, diag, torch.stack([rec_total + zero,
                                                   max_disp + zero, minq]),
                          (it, r0, rn, res_h, upd_h, nw_stalled)))
            if k % c.output_every == 0 or k == c.nsteps:
                _flush_scan_frame(c, m, frame, stall_stats)
                frame = []
                c.save_frame(k, t, T, p, sys_.state_from_arrays(*arrays),
                             vertices=verts.cpu().numpy(),
                             extra=({"recession": np.full(
                                 n, c.recession_total)}
                                 if c.recession_enabled else {}))
        timing.append(c.timing_row(k, timer.step_reset()))
        newton_iters.append(it - 1)
        krylov.append(krylov_step)
        if k <= 5 or k % 50 == 0:
            print(f"step={k} t={t:g} [{branch}] newton_iters={it - 1} "
                  f"{'move' if active else 'still'}")

    state = sys_.state_from_arrays(*arrays) if arrays is not None \
        else state0
    totals = {k: sum(r.get(k, 0.0) for r in timing)
              for k in TIMING_KEYS + ("newton", "total")}
    rec_total = float(rec_total)
    # the tracked-sampler contract: the candidate band must have covered
    # the realized motion, else samples past that depth were NaN
    if rec_total >= m.slack:
        print(f"WARNING: total recession {rec_total:.4e} m "
              f"reached the tracked-sampler slack band {m.slack:.4e} "
              f"m; probe/front samples past that depth were NaN.",
              file=sys.stderr)
    metrics = c.finish(totals, _time.perf_counter() - run_t0)
    wall = totals["total"]
    print(f"scan_stepping: {c.nsteps} steps in {wall:.2f}s "
          f"({wall * 1e3 / max(1, c.nsteps):.1f} ms/step)")
    return {"T": T.cpu().numpy(), "p": p.cpu().numpy(), "state": state,
            "fes": c.fes, "mesh": c.mesh, "step": c.nsteps,
            "time": float(t_edges[-1]), "bprime": c.bprime,
            "recession_total": rec_total,
            "vertices": verts.cpu().numpy(), "handler": None,
            "recession_history": c.recession_history,
            "recession_metrics": metrics, "converged": True,
            "timing": timing, "newton_iters": newton_iters,
            "krylov_iters": krylov, "moved": moved,
            "linear_solver": type(bks).__name__,
            "newton_stall_stats": stall_stats.summary()}


def _flush_scan_frame(c, m, frame, stall_stats):
    """Read one output frame's per-step rows back from the device (one
    transfer per quantity), check the mesh quality and write the CSV rows
    and the Newton histories."""
    diags = [torch.stack([f[2][i] for f in frame]).cpu().numpy()
             for i in range(5)]
    Ts, ps, meqs, bvals, fronts = diags
    mesh_rows = torch.stack([f[3] for f in frame]).cpu().numpy()
    qratio = mesh_rows[:, 2] / m.init_minq
    newton = [f[4] for f in frame if f[4] is not None]
    if newton:
        (r0s, rns, res_hs, upd_hs, stalls) = [
            torch.stack([torch.as_tensor(nw[i]) for nw in newton])
            .cpu().numpy() for i in range(1, 6)]
        stall_stats.update(stalls, rns, r0s)
        if stalls.any():
            print(f"WARNING: {int(stalls.sum())}/{len(frame)} steps "
                  "accepted at the Newton working-precision stall floor "
                  "(not the abs/rel tolerance)", flush=True)
    bad = (mesh_rows[:, 2] <= 0) | (qratio < c.min_quality_ratio)
    if bad.any():
        raise RuntimeError(
            f"Mesh quality ratio below configured minimum threshold "
            f"at step {frame[int(np.nonzero(bad)[0][0])][0]}.")
    j = 0
    for k, (step, t, _, _, nw) in enumerate(frame):
        rec_total = float(mesh_rows[k, 0])
        if step:
            c.recession_total = rec_total
            c.recession_history.append((t, rec_total))
        bdiag = c.sys.boundary_diagnostics_from_values(bvals[k], c.bprime)
        c._write_rows(t, Ts[k], ps[k], meqs[k], bdiag,
                      float(fronts[k, 0]), float(fronts[k, 1]),
                      float(fronts[k, 2]), float(qratio[k]) if step else 1.0,
                      float(mesh_rows[k, 1]), rec_total)
        if nw is not None:
            replay_newton_history(c.newton_csv, step, t, nw[0],
                                  float(r0s[j]), res_hs[j], upd_hs[j])
            j += 1


def main(argv=None):
    args = parse_args("Input/input_ablation_case2_2.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
