"""Wall-clock instrumentation mirroring the reference's per-step timing CSVs
(driver_timing_per_step.csv / driver_timing_summary.csv).  Copy of
``cmfem_tpu/utils/timing.py``, plus ``sync``: a callable run at both ends
of every phase (``torch.cuda.synchronize``), so that a host clock around
device work reads the work and not its enqueue."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StepTimer:
    def __init__(self, sync=None):
        self.phases = defaultdict(float)
        self.totals = defaultdict(float)
        self._sync = sync or (lambda: None)
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
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
