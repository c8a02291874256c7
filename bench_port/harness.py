"""The harness: one cell of ``BENCHMARK.json`` from set-up to result line.

Everything that belongs to one configuration, cell or metric is found by
name under this directory:

- ``configs/<config>.json``: the configuration (its ``kind`` names the
  generator, its ``reference`` the plain reference);
- ``workloads/<cell>.json``: the cell's traffic, read by the generator
  ``kinds/<kind>.py``, and the limits of its output check;
- ``metrics/<metric>.py``: one reader per metric, ``read(record)`` ->
  number or None (None: nothing to read, the metric is left out);
- ``reference/<reference>.py``: the plain reference the check uses.

A generator module defines ``Cell(config, workload, seed, device)``, whose
construction and ``warm()`` are the set-up, ``window(seconds)`` the
measured window (it returns the record the readers read), ``span()`` the
profiled span of a traced run (it returns the units it ran; an optional
``gap_span()`` is the shorter span whose host operations name the idle
gaps),
``release()`` frees the program's state, and ``check()`` returns the
output comparisons as (name, value, limit), each to hold value <= limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cmfem_tpu")


def load_module(kind, name):
    """``<kind>/<name>.py`` under this directory as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"bench_port: no {kind} named {name!r} "
                                f"({path})")
    mod_name = f"bench_port_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind, name):
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def find(bench, key, name):
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"bench_port: BENCHMARK.json has no {key} entry {name!r}")


def load_benchmark(root=None):
    root = Path(root) if root is not None else HERE.parent
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cell_metrics(bench, cell_name, traced):
    """The metric entries a cell reports: the end-to-end ones untraced, the
    per-layer ones traced; an entry with ``workloads`` only in those."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell_name in m["workloads"]]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench, cell_name, seed, seconds, traced, device, t_start,
             sizes=None):
    """The result line (a dict) of one run of ``cell_name``; ``sizes``
    replaces workload entries (the CPU rehearsals' small sizes)."""
    wl_entry = find(bench, "workloads", cell_name)
    cfg_entry = find(bench, "configs", wl_entry["config"])
    with open(HERE.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    workload = {**load_json("workloads", cell_name), **(sizes or {})}
    kind = load_module("kinds", workload["kind"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    cell = kind.Cell(config, workload, seed, device)
    cell.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start

    record = cell.window(float(seconds))
    record["setup_s"] = setup_s
    record["device_type"] = device.type
    trace = None
    if traced:
        trace = tracing.profiled(cell.span, device,
                                 getattr(cell, "gap_span", None))
        record["trace"] = trace
        if trace.value and record["attempted"]:
            print(f"span: {1e3 * trace.window_s / trace.value!r} ms a unit "
                  f"under the profiler; window: "
                  f"{1e3 * record['window_s'] / record['attempted']!r} ms "
                  "a unit", file=sys.stderr)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()

    metrics = {}
    for m in cell_metrics(bench, cell_name, traced):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(wl_entry["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": int(record["attempted"]),
           "failed": int(record["failed"]),
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    chips = int(find(bench, "workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: cell {args.workload} needs {chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}; the benchmark measures "
              "cmfem_tpu_torch alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def setup_environment(root):
    """Keep the compilers' caches at fixed paths inside the checkout (the
    port's own kernels build into ``cmfem_tpu_torch/_build/`` there)."""
    cache = Path(root) / ".bench_port_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
