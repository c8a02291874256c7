"""Profiled spans: device busy time, kernels by name, idle gaps (frozen).

``profiled(span, device, gap_span)`` runs ``span()`` once under
``torch.profiler`` with CUDA activity alone (on the CPU, host activity),
synchronised at both ends, then ``gap_span()`` once with host and CUDA
activity, and reduces the two traces to one ``Trace``:

- from the first: ``window_s``, the host clock around the span (recording
  host operations slows a host-bound span several times over, so it is
  left out here); ``busy_s``, the union of the device's kernel, copy and
  fill intervals; ``kernel_s``, their summed durations, ``by_name`` the
  same per name; ``value``, what ``span()`` returned (its units);
- from the second: ``gaps``, idle seconds on the device summed by what the
  host was doing, named by the host operation that launched the work
  ending each gap (the innermost ``cpu_op`` around its launch call), with
  the span's edges as ``(span start)`` and ``(span end)``.

Each chrome trace is written to the temporary directory, read and deleted.
On the CPU there is no device activity: ``busy_s`` is 0 and the readers
that need the device find nothing.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    kernel_s: float = 0.0
    by_name: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)
    value: object = None

    def top(self, d, k=10):
        return [[name, s] for name, s in
                sorted(d.items(), key=lambda kv: -kv[1])[:k]]

    def breakdown(self):
        return {"device_ops": self.top(self.by_name),
                "idle_gaps": self.top(self.gaps)}


def short_name(name):
    """A kernel's qualified name without its return type, template and
    argument lists (``void ns::kern<float, 3>(float const*)`` ->
    ``ns::kern``); names that are not C++ signatures (``Memcpy DtoD
    (Device -> Device)``) as they are."""
    if "::" not in name and "<" not in name:
        return name
    name = name.replace("(anonymous namespace)", "anon")
    out, depth = [], 0
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">" and depth > 0
    flat = "".join(out)
    flat = flat.split("(")[0].strip()
    return flat.split(" ")[-1][:96]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace(fn, device, host):
    """(events, host seconds, value) of one call of ``fn`` under the
    profiler: CUDA activity, and host activity where ``host`` (always on
    the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if host or device.type != "cuda":
        acts.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_port_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return events, window, value


def profiled(span, device, gap_span=None) -> Trace:
    events, window, value = _trace(span, device, host=False)
    tr = reduce_events(events, window)
    tr.value = value
    if tr.busy_s > 0:
        events, window, _ = _trace(gap_span or span, device, host=True)
        tr.gaps = reduce_events(events, window).gaps
    return tr


def reduce_events(events, window_s) -> Trace:
    """The ``Trace`` of a chrome trace's events (times in microseconds)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    tr = Trace(window_s=window_s)
    if not dev:
        return tr
    dev.sort(key=lambda e: e["ts"])
    by_name = defaultdict(float)
    short = {}
    busy, kernel = 0.0, 0.0
    cur_s, cur_e = dev[0]["ts"], dev[0]["ts"]
    for e in dev:
        d = float(e.get("dur", 0.0))
        kernel += d
        name = e.get("name", "?")
        if name not in short:
            short[name] = short_name(name)
        by_name[short[name]] += d * 1e-6
        s, t = e["ts"], e["ts"] + d
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    tr.busy_s, tr.kernel_s = busy * 1e-6, kernel * 1e-6
    tr.by_name = dict(by_name)
    tr.gaps = _gaps(events, dev, window_s)
    return tr


def _gaps(events, dev, window_s):
    """Idle device seconds summed by the host operation that launched the
    work ending each gap."""
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_ts[c] = e["ts"]
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
    host = [e["ts"] for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")]

    # each gap with the launch time of the work that ends it
    ending = []
    end = dev[0]["ts"] + dev[0].get("dur", 0.0)
    for e in dev[1:]:
        if e["ts"] > end:
            c = (e.get("args") or {}).get("correlation")
            ending.append((launch_ts.get(c), (e["ts"] - end) * 1e-6))
        end = max(end, e["ts"] + e.get("dur", 0.0))
    host_op = _enclosing(ops, sorted({ts for ts, _ in ending
                                      if ts is not None}))

    gaps = defaultdict(float)
    t0 = min(host) if host else dev[0]["ts"]
    if dev[0]["ts"] > t0:
        gaps["(span start)"] += (dev[0]["ts"] - t0) * 1e-6
    for ts, s in ending:
        gaps[host_op[ts] if ts is not None else "(unlaunched)"] += s
    tail = t0 * 1e-6 + window_s - end * 1e-6
    if tail > 0:
        gaps["(span end)"] += tail
    return dict(gaps)


def _enclosing(ops, times):
    """For each of ``times`` (ascending), the name of the innermost
    (latest-starting) of ``ops`` (sorted by start) that encloses it, in one
    sweep: a stack of the ops started so far, those that ended before a
    time popped from its top."""
    names, stack, i = {}, [], 0
    for ts in times:
        while i < len(ops) and ops[i]["ts"] <= ts:
            stack.append(ops[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) < ts:
            stack.pop()
        names[ts] = (stack[-1].get("name", "?") if stack
                     else "(host, no operation)")
    return names
