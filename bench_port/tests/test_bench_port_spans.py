"""The readers of the drivers' spans and host-sync counter
(``run_setup_ms_per_step``, ``step_rest_ms_per_step``,
``host_syncs_per_step``) on synthetic records, rows without the new keys
(a program that has no such span or counter) reading None, and each traced
cell that the three list rehearsed on the CPU at its small size reporting
all three.

Run: ``python -m pytest bench_port/tests -q``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

BENCH = harness.load_benchmark(ROOT)

NEW = ("run_setup_ms_per_step", "step_rest_ms_per_step",
       "host_syncs_per_step")
ROWS = [{"jacobian": 0.10, "factorization": 0.01, "linear": 0.02,
         "total": 0.15, "step_wall": 0.16, "host_syncs": 40,
         "run_setup": 0.03},
        {"jacobian": 0.08, "factorization": 0.01, "linear": 0.03,
         "total": 0.13, "step_wall": 0.13, "host_syncs": 30},
        {"jacobian": 0.09, "factorization": 0.02, "linear": 0.02,
         "total": 0.14, "step_wall": 0.15, "host_syncs": 35,
         "run_finish": 0.006}]


def read(name, record):
    return harness.load_module("metrics", name).read(record)


@pytest.mark.parametrize("name, value", [
    ("run_setup_ms_per_step", 1e3 * 0.036 / 3),
    ("step_rest_ms_per_step", 1e3 * (0.03 + 0.01 + 0.02) / 3),
    ("host_syncs_per_step", 35.0)])
def test_reader_on_synthetic_rows(name, value):
    assert read(name, {"unit": "step", "timing_rows": ROWS}) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_without_the_keys(name):
    # the parent's rows: phases and total, no span and no count
    old = [{k: v for k, v in r.items()
            if k not in ("step_wall", "host_syncs", "run_setup",
                         "run_finish")} for r in ROWS]
    assert read(name, {"unit": "step", "timing_rows": old}) is None
    assert read(name, {"unit": "step", "timing_rows": []}) is None
    assert read(name, {"unit": "apply", "attempted": 10}) is None


@pytest.mark.parametrize("name", NEW)
def test_entry_lists_the_cells_whose_rows_it_reads(name):
    """The metric lists cells, each a run of a driver (whose timing rows
    carry the spans and the count), and moves their step time."""
    m = harness.find(BENCH, "per_layer", name)
    assert m["moves"] == "step_ms"
    assert m["workloads"]
    for cell in m["workloads"]:
        assert harness.load_json("workloads", cell)["kind"] == "driver_runs"


REHEARSE = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from bench_port import harness
out = harness.run_cell(harness.load_benchmark(), {cell!r}, 2**31 + 4099,
                       0.5, True, torch.device("cpu"), t0, {sizes!r})
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell", sorted(
    {c for name in NEW
     for c in harness.find(BENCH, "per_layer", name)["workloads"]}))
def test_traced_rehearsal_reports_the_new_metrics(cell, tmp_path):
    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    code = REHEARSE.format(root=str(ROOT), cell=cell,
                           sizes=harness.load_json("small", cell))
    p = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["run_setup_ms_per_step"] > 0
    assert got["host_syncs_per_step"] > 0
    assert got["step_rest_ms_per_step"] > 0
