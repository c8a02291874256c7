"""A cell is added by new files and entries alone.

In a copy of ``BENCHMARK.json`` and ``bench_port/`` a cell is added with
nothing but a workload file (r0-lu's under a new traffic name), its small
sizes, its ``workloads`` entry and its name in the lists of ``step_ms`` and
of one per-layer metric; the copy's own structural tests then pass with
the new cell among their cases.  No file of the copy is edited but
``BENCHMARK.json``.

Run: ``python -m pytest bench_port/tests -q``."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "ablation-tc1.added"
STRUCTURAL = "found_by_name or contract_shapes or has_small_sizes"


def test_cell_added_by_new_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(ROOT / "bench_port", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("workloads", "small"):
        new = bench_dir / kind / f"{CELL}.json"
        assert not new.exists()
        shutil.copy(bench_dir / kind / "ablation-tc1.r0-lu.json", new)

    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["workloads"].append(
        {"name": CELL, "config": "ablation-tc1", "traffic": "added",
         "chips": 1, "why": "a copy of r0-lu's traffic under a new name"})
    for key, name in (("end_to_end", "step_ms"),
                      ("per_layer", "newton_iters_per_step")):
        entry = next(m for m in bench[key] if m["name"] == name)
        entry["workloads"].append(CELL)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)

    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-k", STRUCTURAL,
         "bench_port/tests/test_bench_port_harness.py"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    passed = [line for line in p.stdout.splitlines()
              if line.startswith("PASSED")]
    for test in ("test_workload_found_by_name", "test_cell_has_small_sizes"):
        assert f"PASSED bench_port/tests/test_bench_port_harness.py::" \
               f"{test}[{CELL}]" in passed, p.stdout[-3000:]
    assert any("test_contract_shapes" in line for line in passed)
