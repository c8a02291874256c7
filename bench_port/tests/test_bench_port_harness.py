"""The harness: files found by name, the contract's shapes, the frozen
arithmetic, the trace reduction, and every cell rehearsed end to end on
the CPU at a small size in a process of its own (the port's plain paths).

Run: ``python -m pytest bench_port/tests -q`` (the ``gpu`` tests run on the
card: ``python -m pytest bench_port/tests -m gpu -q``)."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import arithmetic, harness, tracing  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def smaller(small, full):
    if isinstance(full, list):
        return (isinstance(small, list) and len(small) == len(full)
                and all(map(smaller, small, full)))
    return small <= full


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_has_small_sizes(wl):
    """The cell's sizes for the CPU (``small/<cell>.json``, merged over its
    workload by every CPU test that runs it): each key is a key of its
    workload or of its configuration, and no size is larger than the
    cell's."""
    small = harness.load_json("small", wl["name"])
    cfg = harness.find(BENCH, "configs", wl["config"])
    with open(ROOT / cfg["file"]) as f:
        full = {**json.load(f), **harness.load_json("workloads", wl["name"])}
    assert small and set(small) <= set(full)
    for key, value in small.items():
        assert smaller(value, full[key]), (key, value, full[key])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_found_by_name(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("bench_port/configs/")
    with open(path) as f:
        config = json.load(f)
    assert config["name"] == cfg["name"]
    assert config["reduced"] == cfg["reduced"]
    assert (harness.HERE / "reference" / f"{config['reference']}.py").is_file()


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(wl):
    workload = harness.load_json("workloads", wl["name"])
    assert (harness.HERE / "kinds" / f"{workload['kind']}.py").is_file()
    assert wl["chips"] in (1, 4)
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    mod = harness.load_module("metrics", m["name"])
    assert mod.read({}) is None


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in cells:
        assert any(c in m.get("workloads", [c]) for m in BENCH["per_layer"])
        assert sum(c in m.get("workloads", [c])
                   for m in BENCH["end_to_end"]) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_apply_arithmetic_is_a_hand_count():
    # n = 2, p = 2, q1 = 3: a lattice of N = 5 DOFs and K = 6 points per
    # axis.  D stage: 10 planes x 2 FLOPs x 216 points.  Contractions at
    # 2 (p + 1) = 6 FLOPs an output: x 2 x 6 x 5 x 5 = 300 outputs, y 4 x 6
    # x 6 x 5 = 720, z 6 x 216 = 1,296; forward and transposed.
    assert arithmetic.sumfact_apply_flops(2, 2, 3) == (
        10 * 2 * 216 + 2 * 6 * (300 + 720 + 1296))
    # u and y (125 DOFs each) and one z layer of the 10 planes (10 x 3 x
    # 6 x 6) in float32
    assert arithmetic.sumfact_apply_bytes(2, 2, 3) == 4 * (250 + 1080)
    # the B2 apply at 48^3 is bound by its operations (0.0060 ms)
    flops = arithmetic.sumfact_apply_flops(48, 2, 3)
    nbytes = arithmetic.sumfact_apply_bytes(48, 2, 3)
    from bench_port import peaks

    s, by = peaks.bound_s(nbytes, flops)
    assert by == "operations" and 5.9e-6 < s < 6.1e-6


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 42, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "fill", "ts": 60, "dur": 5},
    ]
    tr = tracing.reduce_events(ev, 100e-6)
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.kernel_s == pytest.approx(35e-6)
    assert tr.gaps["aten::mm"] == pytest.approx(30e-6)
    assert tr.gaps["(span start)"] == pytest.approx(10e-6)
    assert tr.gaps["(span end)"] == pytest.approx(30e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "k2" and len(bd["idle_gaps"]) == 3
    assert tracing.reduce_events([], 1.0).busy_s == 0.0


def test_gap_named_by_innermost_open_operation():
    """A gap is named by the latest-starting host operation still open at
    the launch of the work ending it: past inner operations that ended
    before it, none where no operation is open, none where no launch is
    recorded."""
    def op(name, ts, dur):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                "dur": dur}

    def launch(ts, c):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": c}}

    def kernel(ts, c):
        return {"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": ts,
                "dur": 5, "args": {"correlation": c}}

    ev = [op("outer", 0, 60), op("inner", 10, 20), op("leaf", 12, 3),
          op("late", 70, 5), kernel(1, 0),
          launch(13, 1), kernel(20, 1),   # in leaf
          launch(20, 2), kernel(40, 2),   # in inner, leaf ended
          launch(40, 3), kernel(60, 3),   # in outer, inner ended
          launch(65, 4), kernel(80, 4),   # no operation open
          kernel(100, 5)]                 # no launch recorded
    tr = tracing.reduce_events(ev, 110e-6)
    assert tr.gaps == pytest.approx({
        "leaf": 14e-6, "inner": 15e-6, "outer": 15e-6,
        "(host, no operation)": 15e-6, "(unlaunched)": 15e-6,
        "(span start)": 1e-6, "(span end)": 5e-6})


REHEARSE = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from bench_port import harness
out = harness.run_cell(harness.load_benchmark(), {cell!r}, 2**31 + 977, 0.5,
                       {traced}, torch.device("cpu"), t0, {sizes!r})
print(json.dumps({{"out": out, "loaded": harness.forbidden_modules()}}))
"""


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_rehearsal(cell, traced, tmp_path):
    code = REHEARSE.format(root=str(ROOT), cell=cell, traced=bool(traced),
                           sizes=harness.load_json("small", cell))
    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    out = res["out"]
    assert res["loaded"] == []
    keys = RESULT_KEYS | ({"breakdown"} if traced else set())
    assert set(out) == keys and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    wanted = {m["name"] for m in harness.cell_metrics(BENCH, cell, traced)}
    # the device's metrics have nothing to read on the CPU
    assert set(out["metrics"]) <= wanted
    if not traced:
        assert {"setup_s"} < set(out["metrics"])
    assert out["device"]["count"] == 1
    assert not list(tmp_path.glob("bench_port_*")), "temporary files left"


def test_command_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine with no card")
    p = subprocess.run([sys.executable, str(ROOT / "bench_port" / "run.py"),
                        "--workload", "cdr3d-p2.n48-applies", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_benchmark_alone_refuses_to_run(tmp_path):
    """In a directory with only BENCHMARK.json and bench_port/ the command
    fails and prints no result (the program is not there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(["python3", "bench_port/run.py", "--workload",
                        "cdr3d-p2.n48-applies", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
