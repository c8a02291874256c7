"""Wall-clock instrumentation mirroring the reference's per-step timing CSVs
(driver_timing_per_step.csv / driver_timing_summary.csv).  Copy of
``cmfem_tpu/utils/timing.py``, plus:

- ``sync``: a callable run at both ends of every phase
  (``torch.cuda.synchronize``), so that a host clock around device work
  reads the work and not its enqueue; each call counts one ``host_syncs``;
- spans (``span``): host-clock intervals with no sync of their own, such as
  a run's set-up or a whole step, whose seconds are kept in ``spans``;
- per-step counters (``count``), kept apart from the phase times; while a
  span is open, the module's ``host_sync()`` counts on that timer, so a
  site deep in the solvers or the physics counts where it makes the host
  wait for the device (a ``float``, ``bool``, ``.item()``, ``.cpu()`` of a
  device tensor, or a copy of a host value to the device);
- under an active ``torch.profiler``, each phase and span is also a
  ``record_function`` range ``cmfem.<name>``, on the profiler's clock beside
  the device activity it launched; with no profiler active none is
  entered."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

# the timers whose span is open, innermost last: ``span`` pushes and pops
# it, so that a wait deep in the physics or the solvers counts on the
# driver's timer without the timer being passed down to every call
_open: list = []


def span_count(name: str, k: int = 1):
    """Add ``k`` to the counter ``name`` of the timer whose span is open;
    nothing when none is."""
    if _open:
        _open[-1].count(name, k)


def host_sync(k: int = 1):
    """Count ``k`` host waits for the device (``host_syncs``) on the timer
    whose span is open; nothing when none is.  Call it just before the wait."""
    span_count("host_syncs", k)


def host_copy(a, device):
    """``host_sync()`` before a copy of ``a`` to ``device`` that waits for
    it: a number or an array (counted on a CPU run too, as the card waits
    for it), or a tensor on another kind of device."""
    if not torch.is_tensor(a) or a.device.type != torch.device(device).type:
        host_sync()


def _range(name: str):
    """The profiler range ``cmfem.<name>`` while a profiler records, else a
    context that does nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function("cmfem." + name)
    return nullcontext()


class StepTimer:
    def __init__(self, sync=None):
        self.phases = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = {}
        self._sync = sync

    def _wait(self):
        if self._sync is not None:
            self.count("host_syncs")
            self._sync()

    @contextmanager
    def phase(self, name: str):
        self._wait()
        t0 = time.perf_counter()
        try:
            with _range(name):
                try:
                    yield
                finally:
                    self._wait()
        finally:
            self.phases[name] += time.perf_counter() - t0

    @contextmanager
    def span(self, name: str):
        """The host clock around the block into ``spans[name]`` (seconds),
        with no sync; inside it ``host_sync()`` counts on this timer."""
        t0 = time.perf_counter()
        _open.append(self)
        try:
            with _range(name):
                yield
        finally:
            _open.pop()
            self.spans[name] = time.perf_counter() - t0

    def count(self, name: str, k: int = 1):
        """Add ``k`` to this step's counter ``name``."""
        self.counts[name] += k

    def step_reset(self):
        """End-of-step: return this step's phase seconds, their sum as
        ``total`` and beside them its counts, and reset both."""
        out = dict(self.phases)
        out["total"] = sum(self.phases.values())
        out.update(self.counts)
        self.phases.clear()
        self.counts.clear()
        return out
