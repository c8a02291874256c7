"""The case-2.2 driver's spans, phases and counters (eager, host LU) on a
3 x 20 quad strip with the synthetic TACOT deck and the case-2.1 schedule
(two steps, both on the chemistry-blowing branch, the top receding): every
row carries ``step_wall`` and ``host_syncs``; its ``face_jacobian`` (the
SEB face blocks) lies inside its ``jacobian``; the moving mesh's four
phases sum to its ``recession``; the smoother counts its CG iterations
(``mesh_cg_iters``) on a moving step; the first row carries the run's
``run_setup`` and the last its ``run_finish``; the per-step timing CSV
keeps its columns; the benchmark's three readers of these rows
(``face_jacobian_ms_per_step``, ``mesh_motion_ms_per_step``,
``mesh_cg_iters_per_step``) read them; and every face-Jacobian call is
counted, eager on the CPU (``face_jacobian_graph_replay_pct`` reads 0).

Run: ``python -m pytest tests/test_torch_ablation_case2_2_spans.py -q``"""

import os
import sys

import pytest

from torch_ablation_helpers import case22_cfg, one_torch_thread, strip_file  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("recession_velocity", "mesh_velocity", "remap", "mesh_move")
CSV_COLUMNS = ["step", "bc_sec", "newton_sec", "newton_residual_eval_sec",
               "newton_jacobian_sec", "newton_linear_sec",
               "newton_update_sec", "state_advance_sec", "output_sec",
               "step_total_sec"]
READERS = ("face_jacobian_ms_per_step", "mesh_motion_ms_per_step",
           "mesh_cg_iters_per_step")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from cmfem_tpu_torch.apps import ablation_case2_2

    tmp = tmp_path_factory.mktemp("case22_spans")
    out_dir = str(tmp / "out")
    cfg = case22_cfg(strip_file(tmp, 3, 20), out_dir, t_final=0.2,
                     linear_solver="lu")
    return ablation_case2_2.run(cfg, device="cpu"), out_dir


def test_every_row_carries_the_step_span_and_the_sync_count(run):
    out, _ = run
    rows = out["timing"]
    assert len(rows) == 2 and all(out["moved"])
    for r in rows:
        assert r["step_wall"] >= r["total"] > 0
        assert r["host_syncs"] > 0
    assert rows[0]["run_setup"] > 0 and "run_setup" not in rows[1]
    assert rows[-1]["run_finish"] > 0 and "run_finish" not in rows[0]


def test_face_jacobians_lie_inside_the_jacobian_phase(run):
    for r in run[0]["timing"]:
        assert 0 < r["face_jacobian"] <= r["jacobian"]


def test_recession_is_the_sum_of_its_phases(run):
    for r in run[0]["timing"]:
        assert all(r[k] > 0 for k in PHASES)
        assert r["recession"] == pytest.approx(sum(r[k] for k in PHASES),
                                               rel=1e-12)
        # the CSV's bc_sec holds the recession, as the JAX driver's
        assert r["bc"] >= r["recession"]


def test_smoother_counts_its_iterations_on_a_moving_step(run):
    for r in run[0]["timing"]:
        assert r["mesh_cg_iters"] > 0


def test_timing_csv_keeps_its_columns(run):
    out, out_dir = run
    with open(os.path.join(out_dir, "driver_timing_per_step.csv")) as f:
        lines = [line.strip().split(",") for line in f if line.strip()]
    assert lines[0] == CSV_COLUMNS
    assert len(lines) == 1 + len(out["timing"])
    for line, r in zip(lines[1:], out["timing"]):
        assert float(line[1]) == pytest.approx(r["bc"], rel=1e-12)
        assert float(line[4]) == pytest.approx(
            r["jacobian"] + r["factorization"], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_benchmark_readers_read_the_rows(run, name):
    sys.path.insert(0, ROOT)
    from bench_port import harness

    rows = run[0]["timing"]
    value = harness.load_module("metrics", name).read(
        {"unit": "step", "attempted": len(rows), "timing_rows": rows})
    assert value is not None and value > 0
    key = {"face_jacobian_ms_per_step": "face_jacobian",
           "mesh_motion_ms_per_step": "recession",
           "mesh_cg_iters_per_step": "mesh_cg_iters"}[name]
    scale = 1.0 if key == "mesh_cg_iters" else 1e3
    assert value == pytest.approx(scale * sum(r[key] for r in rows)
                                  / len(rows))


def test_face_jacobian_calls_are_counted_eager_on_the_cpu(run):
    """One face-Jacobian call with each element-Jacobian call, all eager on
    the CPU; the reader of ``face_jacobian_graph_replay_pct`` reads 0."""
    sys.path.insert(0, ROOT)
    from bench_port import harness

    rows = run[0]["timing"]
    for r in rows:
        assert r["face_jacobian_eager"] == r["jacobian_eager"] > 0
        assert "face_jacobian_captures" not in r
        assert "face_jacobian_replays" not in r
    read = harness.load_module("metrics",
                               "face_jacobian_graph_replay_pct").read
    assert read({"unit": "step", "timing_rows": rows}) == 0.0
