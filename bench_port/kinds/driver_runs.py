"""Whole runs of an ablation driver, back to back (closed loop).

The configuration names the driver (``driver``: a module of
``cmfem_tpu_torch.apps`` with ``run(cfg)``), the strip (``strip``: cells
across and along), the time step, the wall schedule, the top pressure and
the material deck (``material``, written to a file for the driver).  The
workload gives the steps of a run (``steps``) and the driver options it
sets (``options``); ``refine`` refines the strip uniformly that many
times before the mesh file is written (the reference numbers the refined
vertices itself, so the driver reads the refined mesh and does not refine
it again).  Each run's wall plateau temperature and top pressure
are drawn from the seed and the run's index, within ``deck_spread`` of the
configuration's, so no two runs of a window are the same problem and every
run does the same amount of work.  A run is what a user of the driver
runs: mesh file, material file, set-up, ``steps`` steps, the CSV and
ParaView outputs (under the temporary directory, deleted after each run).

The step's state is read where the driver commits it
(``AblationSystem.advance_state_arrays``, wrapped for the life of the
cell): the converged (T, p) of every step and the element means of its
extents.  The check has two parts, each drawn from the seed:

- the window's first run whole, integrated again by the plain reference
  from the deck's initial fields, each step by its own Newton from its own
  previous state and extents: the program's T (K), p (relative to its
  largest value) and element-mean extents at every step of the run
  (``run_T_max_abs_K``, ``run_p_max_rel``, ``run_extent_max_abs``);
- a sample of the later runs' steps (``check_samples``), each from the
  program's previous (T, p) and the reference's own extents, advanced
  along the program's temperatures from zero, which judges a step alone
  (``T_max_abs_K``, ``p_max_rel``, ``extent_max_abs``).

A number the workload gives no limit is not compared.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from bench_port import common
from bench_port.harness import load_module


class Cell:
    def __init__(self, config, workload, seed, device):
        import importlib

        from cmfem_tpu_torch.physics.ablation import AblationSystem

        self.config, self.workload, self.device = config, workload, device
        self.driver = importlib.import_module(config["driver"])
        self.ref_mod = load_module("reference", config["reference"])
        self.tmp = tempfile.mkdtemp(prefix="bench_port_")
        atexit.register(shutil.rmtree, self.tmp, True)
        nx, ny = workload.get("strip", config["strip"])
        self.mesh = self.ref_mod.strip_mesh(nx, ny)
        for _ in range(int(workload.get("refine", 0))):
            self.mesh = self.ref_mod.refine(*self.mesh)
        mesh_file = self.ref_mod.write_gmsh(
            os.path.join(self.tmp, "strip.msh"), *self.mesh)
        material_file = os.path.join(self.tmp, "material.json")
        with open(material_file, "w") as f:
            json.dump(config["material"], f)
        self.steps = int(workload["steps"])
        self.dt = float(config["dt"])
        self.base = {"mesh_file": mesh_file, "material_file": material_file,
                     "order": 1, "dt": self.dt,
                     "t_final": self.steps * self.dt,
                     "bdr_attr_top": int(config["top_attribute"]),
                     "probe_x": float(config["probe_x"]),
                     "output_every": self.steps,
                     **workload.get("options", {})}
        self.seed_inputs(seed)
        self.records = None
        self._orig = AblationSystem.advance_state_arrays
        cell = self

        def hooked(sys_self, X_old, T, p, dt):
            out = cell._orig(sys_self, X_old, T, p, dt)
            if cell.records is not None:
                cell.records.append((T.detach().clone(), p.detach().clone(),
                                     float(dt), out[0].mean(dim=1).detach()))
            return out

        AblationSystem.advance_state_arrays = hooked
        self._system = AblationSystem

    def seed_inputs(self, seed):
        """The seed's decks and a fresh sample; the records kept so far
        are dropped."""
        self.seed = int(seed)
        self.runs = []
        self.sample = common.Reservoir(int(self.workload["check_samples"]),
                                       common.host_rng(seed))

    def deck(self, index):
        """(wall plateau K, top pressure Pa) of run ``index``."""
        g = common.generator(self.seed * 7919 + index, "cpu")
        u = 2.0 * torch.rand(2, generator=g, dtype=torch.float64) - 1.0
        s = float(self.workload["deck_spread"])
        return (float(self.config["wall_plateau"]) * (1 + s * float(u[0])),
                float(self.config["top_pressure"]) * (1 + s * float(u[1])))

    def schedule(self, wall):
        t_ramp, t_hold = self.config["wall_ramp_s"], self.config["wall_hold_s"]
        T0 = float(self.config["initial_temperature"])
        return [[0.0, T0], [t_ramp, wall], [t_hold, wall],
                [t_hold + t_ramp, T0], [2 * t_hold, T0]]

    def _run(self, index, steps=None):
        wall, p_top = self.deck(index)
        out_dir = os.path.join(self.tmp, f"run{index}")
        cfg = {**self.base, "output_path": out_dir,
               "top_temperature_schedule": self.schedule(wall),
               "top_pressure": p_top}
        if steps is not None:
            cfg.update(t_final=steps * self.dt, output_every=steps)
        try:
            return self.driver.run(cfg, device=self.device)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)

    def warm(self):
        """A run of ``warm_steps`` steps: every shape of the window's runs."""
        self._run(-1, steps=int(self.workload["warm_steps"]))

    def window(self, seconds):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        steps = failed = 0
        newton, rows = [], []
        index = 0
        while time.perf_counter() < deadline:
            self.records = []
            out = self._run(index)
            recs, self.records = self.records, None
            if len(recs) != self.steps:
                raise RuntimeError(f"run {index} committed {len(recs)} "
                                   f"steps, expected {self.steps}")
            self.runs.append((index, recs))
            for k in range(self.steps if index else 0):
                self.sample.offer(lambda: (index, k))
            steps += self.steps
            failed += 0 if out.get("converged", True) else self.steps
            newton += list(out["newton_iters"])
            rows += list(out["timing"])
            index += 1
        common.sync(self.device)
        window_s = time.perf_counter() - t0
        return {"unit": "step", "attempted": steps, "failed": failed,
                "window_s": window_s, "newton_iters": newton,
                "timing_rows": rows}

    def span(self):
        """One whole run, as the window runs them, for the profiler."""
        self._run(-2)
        return self.steps

    def gap_span(self):
        """A run of ``span_steps`` steps, traced with the host."""
        k = int(self.workload["span_steps"])
        self._run(-3, steps=k)
        return k

    def use_control(self):
        """Put the plain reference in the program's place, computed in the
        configuration's ``control_dtype``: each run's steps are solved by
        the reference's Newton there, from its own previous step."""
        dtype = getattr(torch, self.config["control_dtype"])
        ref = self._reference(dtype)

        def run(index):
            wall, p_top = self.deck(index)
            T, p = self._initial(wall, p_top)
            X = self._zero_extents().to(dtype)
            recs = []
            for k in range(self.steps):
                T, p, _ = ref.newton(T, p, X, self.dt, self._wall(wall, k),
                                     p_top)
                X = ref.advance(X, T, self.dt)
                recs.append((T.double(), p.double(), self.dt,
                             X.mean(dim=1).double()))
            return {"newton_iters": [0] * self.steps,
                    "timing": [{}] * self.steps}, recs

        def _run(index, steps=None):
            out, recs = run(index)
            if self.records is not None:
                self.records.extend(recs)
            return out

        self._run = _run

    @property
    def nr(self):
        return len(self.config["material"]["reactions"])

    def _reference(self, dtype):
        verts, quads, segs, attrs = self.mesh
        top = np.unique(segs[attrs == int(self.config["top_attribute"])])
        return self.ref_mod.Case1Reference(self.config["material"], verts,
                                           quads, top, self.device, dtype)

    def _initial(self, wall, p_top):
        """The deck's fields before a run's first step (the wall at the
        schedule's start value)."""
        nv = len(self.mesh[0])
        T0 = float(self.config["initial_temperature"])
        T = torch.full((nv,), T0, dtype=torch.float64, device=self.device)
        p = torch.full((nv,), p_top, dtype=torch.float64, device=self.device)
        return T, p

    def release(self):
        self._system.advance_state_arrays = self._orig
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _wall(self, wall, k):
        """The wall temperature at the end of step ``k`` of a run."""
        return float(np.interp((k + 1) * self.dt, *zip(*self.schedule(wall))))

    def _zero_extents(self):
        return torch.zeros((len(self.mesh[1]), 9, self.nr),
                           dtype=torch.float64, device=self.device)

    def check(self):
        ref = self._reference(torch.float64)
        runs = dict(self.runs)
        found = dict.fromkeys(("run_T_max_abs_K", "run_p_max_rel",
                               "run_extent_max_abs", "T_max_abs_K",
                               "p_max_rel", "extent_max_abs"), 0.0)

        def compare(prefix, rec, T, p, Xmean):
            errs = (float((rec[0] - T).abs().max()),
                    float((rec[1] - p).abs().max() / p.abs().max()),
                    float((rec[3] - Xmean).abs().max()))
            for name, e in zip(("T_max_abs_K", "p_max_rel",
                                "extent_max_abs"), errs):
                found[prefix + name] = max(found[prefix + name], e)

        # the first run whole, from the deck's initial fields
        wall, p_top = self.deck(0)
        T, p = self._initial(wall, p_top)
        X = self._zero_extents()
        for k, rec in enumerate(runs[0]):
            T, p, _ = ref.newton(T, p, X, rec[2], self._wall(wall, k), p_top)
            X = ref.advance(X, T, rec[2])
            compare("run_", rec, T, p, X.mean(dim=1))
        # sampled steps of the later runs, each from the program's state
        for index, k in sorted(self.sample.items):
            recs = runs[index]
            wall, p_top = self.deck(index)
            if k == 0:
                T_prev, p_prev = self._initial(wall, p_top)
            else:
                T_prev, p_prev = recs[k - 1][0], recs[k - 1][1]
            X = self._zero_extents()
            for j in range(k):
                X = ref.advance(X, recs[j][0], recs[j][2])
            T, p, dt, _ = recs[k]
            Ts, ps, _ = ref.newton(T_prev, p_prev, X, dt,
                                   self._wall(wall, k), p_top)
            Xs = ref.advance(X, T, dt).mean(dim=1)
            # T and p from the reference's Newton; the extents of the
            # program's T, as the program committed them
            compare("", (recs[k][0], recs[k][1], dt, recs[k][3]), Ts, ps, Xs)
        return [(name, found[name], float(lim))
                for name, lim in self.workload["limits"].items()]
