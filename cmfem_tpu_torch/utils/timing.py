"""Wall-clock instrumentation mirroring the reference's per-step timing CSVs
(driver_timing_per_step.csv / driver_timing_summary.csv).  Copy of
``cmfem_tpu/utils/timing.py``."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StepTimer:
    def __init__(self):
        self.phases = defaultdict(float)
        self.totals = defaultdict(float)
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] += dt
            self.totals[name] += dt

    def step_reset(self):
        """End-of-step: return this step's phase dict and reset it."""
        out = dict(self.phases)
        out["total"] = sum(self.phases.values())
        self.phases.clear()
        return out

    def summary(self):
        out = dict(self.totals)
        out["wall"] = time.perf_counter() - self._t0
        return out
