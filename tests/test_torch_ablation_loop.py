"""The ablation drivers' one eager time loop (``apps.ablation_loop``) on a
3 x 20 strip with the synthetic TACOT deck (case 2.2 on triangles, the
top receding from step 1), host LU, two steps: for each case every timing
row carries the step's wall time and its host waits, the first row the
run's set-up and the last its finish, and the per-step timing CSV keeps its
columns; and a case-2.1 run restarted from its checkpoint at t = 0.2 writes
the uninterrupted run's rows from there on, line for line.

Run: ``python -m pytest tests/test_torch_ablation_loop.py -q``"""

import importlib
import os

import numpy as np
import pytest

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, SCHED, TOP, case22_cfg, one_torch_thread, strip_file)

CASES = {"case1": "ablation_case1", "case2_1": "ablation_case2_1",
         "case2_2": "ablation_case2_2"}
CSV_COLUMNS = ("step,bc_sec,newton_sec,newton_residual_eval_sec,"
               "newton_jacobian_sec,newton_linear_sec,newton_update_sec,"
               "state_advance_sec,output_sec,step_total_sec")
ROWS21 = ("temperature_probes.csv", "mass_metrics.csv",
          "boundary_diagnostics.csv")
NEWTON21 = "newton_history_ablation_case2_1_2D.csv"


@pytest.fixture(scope="module")
def strips(tmp_path_factory):
    d = tmp_path_factory.mktemp("strips")
    return {g: strip_file(d, 3, 20, geom=g) for g in ("quad", "triangle")}


def _cfg(case, strips, out, **extra):
    if case == "case2_2":
        return case22_cfg(strips["triangle"], out, t_final=0.2,
                          linear_solver="lu", **extra)
    cfg = {"mesh_file": strips["quad"], "material_file": FIXTURE,
           "order": 1, "dt": 0.1, "t_final": 0.2, "bdr_attr_top": TOP,
           "probe_x": 0.00125, "newton_print_level": 0,
           "save_paraview": False, "output_every": 1,
           "output_path": str(out), **extra}
    if case == "case2_1":
        cfg["boundary_conditions_file"] = SCHED
    return cfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_rows_carry_the_run_spans_and_the_host_syncs(strips, tmp_path,
                                                           case):
    run = importlib.import_module(
        f"cmfem_tpu_torch.apps.{CASES[case]}").run
    rows = run(_cfg(case, strips, tmp_path), device="cpu")["timing"]
    assert len(rows) == 2
    for r in rows:
        assert r["step_wall"] >= r["total"] > 0
        assert r["host_syncs"] >= 1
    assert rows[0]["run_setup"] > 0 and "run_setup" not in rows[1]
    assert rows[-1]["run_finish"] > 0 and "run_finish" not in rows[0]
    with open(os.path.join(str(tmp_path),
                           "driver_timing_per_step.csv")) as f:
        lines = [line.strip() for line in f if line.strip()]
    assert lines[0] == CSV_COLUMNS and len(lines) == 1 + len(rows)


def _lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def test_restarted_case21_run_writes_the_uninterrupted_tail(strips,
                                                            tmp_path):
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    chk = str(tmp_path / "t02.chk")
    whole = P.run(_cfg("case2_1", strips, tmp_path / "whole", t_final=0.4,
                       restart_write_file=chk, restart_write_at_time=0.2,
                       restart_write_at_end=False), device="cpu")
    tail = P.run(_cfg("case2_1", strips, tmp_path / "tail", t_final=0.4,
                      restart_read_file=chk), device="cpu")
    assert (whole["step"], tail["step"]) == (4, 4)
    assert whole["time"] == tail["time"] == pytest.approx(0.4, abs=1e-12)
    assert tail["newton_iters"] == whole["newton_iters"][2:]
    for k in ("T", "p"):
        np.testing.assert_array_equal(tail[k], whole[k])
    # the restart's first row is the checkpoint's time, t = 0.2
    for name in ROWS21:
        a = _lines(tmp_path / "whole" / name)
        b = _lines(tmp_path / "tail" / name)
        assert len(a) == 6 and b == a[:1] + a[-3:], name
    a = _lines(tmp_path / "whole" / NEWTON21)
    b = _lines(tmp_path / "tail" / NEWTON21)
    assert b[0] == a[0]
    assert b[1:] == [line for line in a[1:]
                     if int(line.split(",")[0]) > 2]
    assert len(b) == 1 + sum(n + 1 for n in tail["newton_iters"])
