"""``cmfem_tpu_torch.utils.timing``: the drivers' one span and counter
facility.  Phases keep their host clock and their syncs, each sync counted
as one ``host_syncs``; spans time a block with no sync; counts stay apart
from the phase seconds; ``host_sync()`` and ``host_copy()`` count on the
timer whose span is open; under ``torch.profiler`` every phase and span is a
``cmfem.<name>`` range of the trace, and with no profiler active no
``record_function`` is entered."""

import json

import numpy as np
import pytest
import torch

from cmfem_tpu_torch.utils import timing
from cmfem_tpu_torch.utils.timing import StepTimer, host_copy, host_sync


class _Spy:
    """A stand-in for ``record_function`` that records its names."""

    names = []

    def __init__(self, name):
        _Spy.names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_no_range_without_a_profiler(monkeypatch):
    _Spy.names = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Spy)
    timer = StepTimer(sync=lambda: None)
    with timer.span("step"):
        with timer.phase("jacobian"):
            torch.ones(3).sum()
        host_sync()
    timer.step_reset()
    assert _Spy.names == []


def test_one_range_per_phase_and_span_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    timer = StepTimer(sync=lambda: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("step"):
            for name in ("jacobian", "jacobian", "linear"):
                with timer.phase(name):
                    torch.ones(4) * 2.0
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    assert sorted(n for n in names if n.startswith("cmfem.")) == [
        "cmfem.jacobian", "cmfem.jacobian", "cmfem.linear", "cmfem.step"]


def test_counts_stay_apart_from_the_phase_times():
    waits = []
    timer = StepTimer(sync=lambda: waits.append(1))
    host_sync()                      # no span open: counted nowhere
    with timer.span("step"):
        with timer.phase("a"):
            host_sync(3)
        with timer.phase("b"):
            pass
        timer.count("solves", 2)
        host_copy(1.0, "cpu")        # a number: the card copies it
        host_copy(np.ones(2), "cpu")
        host_copy(torch.ones(2), "cpu")  # already there
    rec = timer.step_reset()
    assert len(waits) == 4
    assert rec["host_syncs"] == 4 + 3 + 2 and rec["solves"] == 2
    assert rec["total"] == pytest.approx(rec["a"] + rec["b"])
    assert timer.spans["step"] >= rec["total"]
    assert timer.step_reset() == {"total": 0.0}
    assert timing._open == []


def test_a_timer_without_sync_counts_nothing():
    timer = StepTimer()
    with timer.phase("solve"):
        pass
    assert set(timer.step_reset()) == {"solve", "total"}


def test_the_innermost_span_counts_and_totals_are_gone():
    outer, inner = StepTimer(), StepTimer()
    with outer.span("run"):
        with inner.span("step"):
            host_sync()
        host_sync(2)
    assert outer.counts["host_syncs"] == 2
    assert inner.counts["host_syncs"] == 1
    assert not hasattr(outer, "totals") and not hasattr(StepTimer, "summary")
