"""Whole runs of the ablation case-2.2 driver, back to back (closed loop).

``driver_runs``' cell with a receding top: the configuration adds the
surface schedule (``surface_schedule``), the B' table stated as data
(``bprime``, written to a PATO-format file for the driver's
``bprime_table_file``), the surface model the driver takes by default
(``surface_model``), the bottom's attribute and the mesh-motion options
(``driver_options``).  Each run's rho_e u_e C_H plateau and h_r are drawn
from the seed and the run's index within ``deck_spread`` of the
configuration's, and its schedule is written to a file of its own.

The step's state is read where the driver commits it: the moved vertices
and the total recession where the mesh handler commits the move
(``MeshRecessionHandler.commit_advance``), then the converged (T, p), the
step's dt and its full quadrature-point extents where the system advances
them (``AblationSystem.advance_state_arrays``); both are wrapped for the
life of the cell.  The check has two parts, each drawn from the seed:

- the window's first run whole, integrated again by the plain reference
  from the deck's initial fields and mesh: T (K), p (relative to its
  largest value), the extents, the vertices (m) and the total recession
  (relative) at every step (``run_T_max_abs_K``, ``run_p_max_rel``,
  ``run_extent_max_abs``, ``run_vertex_max_abs_m``,
  ``run_recession_max_rel``);
- a sample of the window's steps after its first (``check_samples``: the
  later runs' steps and the first run's second and later ones, so that a
  window of one run is sampled too), each from the program's previous T,
  p, extents and vertices, which judges a step alone (``T_max_abs_K``,
  ``p_max_rel``, ``extent_max_abs``, ``vertex_max_abs_m``); with no such
  step they read infinite, and fail.

The warm-up run also checks that the program's mesh-velocity CG reached
its tolerance at every step: one that stops before it (the CG's stall
exits) leaves a velocity the reference does not meet, and the cell stops
there.  A number the workload gives no limit is not compared.
"""

from __future__ import annotations

import os
import shutil

import torch

from bench_port import common
from bench_port.harness import load_module

driver_runs = load_module("kinds", "driver_runs")

NAMES = ("run_T_max_abs_K", "run_p_max_rel", "run_extent_max_abs",
         "run_vertex_max_abs_m", "run_recession_max_rel", "T_max_abs_K",
         "p_max_rel", "extent_max_abs", "vertex_max_abs_m")


class Cell(driver_runs.Cell):
    def __init__(self, config, workload, seed, device):
        from cmfem_tpu_torch.motion.recession import MeshRecessionHandler

        super().__init__(config, workload, seed, device)
        system = self._system
        system.advance_state_arrays = self._orig      # the parent's hook off
        self.rows = self.ref_mod.bprime_rows(config["bprime"])
        bprime_file = os.path.join(self.tmp, "bprime.dat")
        with open(bprime_file, "w") as f:
            f.write("// p B'g B'c T h_w\n")
            f.writelines(" ".join(repr(float(v)) for v in r) + "\n"
                         for r in self.rows)
        self.base.update(bdr_attr_bottom=int(config["bottom_attribute"]),
                         bprime_table_file=bprime_file,
                         **config["driver_options"])
        self._handler = MeshRecessionHandler
        self._orig_commit = MeshRecessionHandler.commit_advance
        cell, moved = self, {}

        def commit(h_self):
            out = cell._orig_commit(h_self)
            moved["at"] = (torch.as_tensor(h_self.vertices.copy()),
                           float(out["total_recession"]))
            return out

        def advance(sys_self, X_old, T, p, dt):
            out = cell._orig(sys_self, X_old, T, p, dt)
            if cell.records is not None:
                V, total = moved.pop("at")
                cell.records.append((T.detach().clone(), p.detach().clone(),
                                     float(dt), out[0].detach().clone(), V,
                                     total))
            return out

        MeshRecessionHandler.commit_advance = commit
        system.advance_state_arrays = advance

    def warm(self):
        from cmfem_tpu_torch.motion.recession import LaplacianSmoother

        orig, stopped = LaplacianSmoother.solve, []

        def solve(smoother, *args, **kwargs):
            res = orig(smoother, *args, **kwargs)
            if not res.converged:
                stopped.append((res.iters, res.rel_residual))
            return res

        LaplacianSmoother.solve = solve
        try:
            super().warm()
        finally:
            LaplacianSmoother.solve = orig
        if stopped:
            raise RuntimeError("bench_port: the program's mesh-velocity CG "
                               "stopped before its tolerance (iterations, "
                               f"relative residual): {stopped}")

    def window(self, seconds):
        out = super().window(seconds)
        for k in range(1, self.steps):
            self.sample.offer(lambda: (0, k))
        return out

    def deck(self, index):
        """(rho_e u_e C_H plateau, h_r) of run ``index``."""
        g = common.generator(self.seed * 7919 + index, "cpu")
        u = 2.0 * torch.rand(2, generator=g, dtype=torch.float64) - 1.0
        s = float(self.workload["deck_spread"])
        sc = self.config["surface_schedule"]
        return (float(sc["rheuch_plateau"]) * (1 + s * float(u[0])),
                float(sc["h_r"]) * (1 + s * float(u[1])))

    def schedule_rows(self, index):
        return self.ref_mod.schedule_rows(self.config["surface_schedule"],
                                          *self.deck(index))

    def _run(self, index, steps=None):
        out_dir = os.path.join(self.tmp, f"run{index}")
        sched = os.path.join(self.tmp, f"schedule{index}.dat")
        with open(sched, "w") as f:
            f.write("// t p_w rhoeUeCH h_r hconv T_edge chemistryOn\n")
            f.writelines(" ".join(repr(float(v)) for v in r) + "\n"
                         for r in self.schedule_rows(index))
        cfg = {**self.base, "output_path": out_dir,
               "boundary_conditions_file": sched}
        if steps is not None:
            cfg.update(t_final=steps * self.dt, output_every=steps)
        try:
            return self.driver.run(cfg, device=self.device)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
            os.remove(sched)

    def _reference(self, dtype):
        verts, quads, segs, attrs = self.mesh
        top = segs[attrs == int(self.config["top_attribute"])]
        bottom = segs[attrs == int(self.config["bottom_attribute"])]
        return self.ref_mod.Case22Reference(
            self.config["material"], verts, quads, top, bottom, self.rows,
            self.config["surface_model"], self.device, dtype)

    def _initial(self, rows):
        """The deck's fields, extents, vertices and recession before a
        run's first step."""
        nv = len(self.mesh[0])
        full = lambda v: torch.full((nv,), float(v), dtype=torch.float64,
                                    device=self.device)
        p_w = self.ref_mod.boundary(rows, 0.0)["p_w"]
        return (full(self.config["initial_temperature"]), full(p_w),
                self._zero_extents(),
                torch.as_tensor(self.mesh[0], dtype=torch.float64), 0.0)

    def _times(self):
        """The end time of each step of a run, accumulated as the driver
        does."""
        t, out = 0.0, []
        for _ in range(self.steps):
            t = min(self.steps * self.dt, t + self.dt)
            out.append(t)
        return out

    def use_control(self):
        """Put the plain reference in the program's place, computed in the
        configuration's ``control_dtype``: each run's steps are taken by
        the reference there, from its own previous step."""
        ref = self._reference(getattr(torch, self.config["control_dtype"]))

        def _run(index, steps=None):
            rows = self.schedule_rows(index)
            T, p, X, V, total = self._initial(rows)
            t_prev = 0.0
            for t in self._times():
                T, p, X, V, total = ref.step(T, p, X, V, total, t - t_prev,
                                             self.ref_mod.boundary(rows, t))
                if self.records is not None:
                    self.records.append((T.double(), p.double(), t - t_prev,
                                         X.double(), V.double().cpu(),
                                         float(total)))
                t_prev = t
            return {"newton_iters": [0] * self.steps,
                    "timing": [{}] * self.steps}

        self._run = _run

    def release(self):
        self._handler.commit_advance = self._orig_commit
        super().release()

    def check(self):
        ref = self._reference(torch.float64)
        runs = dict(self.runs)
        found = dict.fromkeys(NAMES, 0.0)
        if not self.sample.items:
            found.update(dict.fromkeys(NAMES[5:], float("inf")))
        times = self._times()

        def compare(prefix, rec, T, p, X, V, total=None):
            errs = {"T_max_abs_K": float((rec[0] - T).abs().max()),
                    "p_max_rel": float((rec[1] - p).abs().max()
                                       / p.abs().max()),
                    "extent_max_abs": float((rec[3] - X).abs().max()),
                    "vertex_max_abs_m": float((rec[4].to(V) - V).abs()
                                              .max())}
            if total is not None:
                errs["recession_max_rel"] = abs(rec[5] - total) / max(
                    abs(total), 1e-300)
            for name, e in errs.items():
                found[prefix + name] = max(found[prefix + name], e)

        # the first run whole, from the deck's initial fields and mesh
        rows = self.schedule_rows(0)
        T, p, X, V, total = self._initial(rows)
        for rec, t in zip(runs[0], times):
            T, p, X, V, total = ref.step(T, p, X, V, total, rec[2],
                                         self.ref_mod.boundary(rows, t))
            compare("run_", rec, T, p, X, V, total)
        # the sampled steps, each from the program's state
        for index, k in sorted(self.sample.items):
            recs = runs[index]
            rows = self.schedule_rows(index)
            if k == 0:
                T, p, X, V, _ = self._initial(rows)
            else:
                T, p, _, X, V, _ = recs[k - 1]
            T, p, X, V, _ = ref.step(T, p, X, V, 0.0, recs[k][2],
                                     self.ref_mod.boundary(rows, times[k]))
            compare("", recs[k], T, p, X, V)
        return [(name, found[name], float(lim))
                for name, lim in self.workload["limits"].items()]
