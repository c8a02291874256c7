"""Port parity, ``cmfem_tpu_torch.scripts.fullrun`` and ``oracle_compare``:
on port-written output directories (cases 1 and 2.2 on 3 x 20 strips of
the module's synthetic decks, 2 steps, the eager path and
``scan_stepping``), ``fullrun.summarize`` gives the JAX script's dict but
for ``deck``, ``platform`` and ``hostname``, and
``oracle_compare.compare_case`` of the two directories gives the JAX
script's result exactly (both are numpy on the same CSVs).  ``main`` runs a
case end to end on the CPU, rebuilds an artifact with --summarize-only and
asks for the card by default."""

import json
import os

import numpy as np
import pytest
import torch

from torch_ablation_helpers import one_torch_thread  # noqa: F401
from torch_scripts_helpers import jax_script

from cmfem_tpu_torch.scripts import fullrun, oracle_compare

CASES = ("case1", "case2_2")


def _cfg(case, out, **extra):
    cfg = fullrun.deck(case, str(out), nx=3, ny=20)
    cfg.update(output_path=str(out), save_paraview=False, t_final=2 *
               cfg["dt"], newton_print_level=0, output_every=2, **extra)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (eager cfg, eager dir, scan dir)}: 2 steps each on the CPU."""
    import importlib

    out = {}
    for case in CASES:
        run = importlib.import_module(
            f"cmfem_tpu_torch.apps.{fullrun.DECKS[case][0]}").run
        dirs = []
        for scan in (False, True):
            d = tmp_path_factory.mktemp(f"{case}_{'scan' if scan else 'eager'}")
            cfg = _cfg(case, d, scan_stepping=scan)
            run(cfg, device="cpu")
            dirs.append(str(d))
        out[case] = (_cfg(case, dirs[0]), *dirs)
    return out


@pytest.mark.parametrize("case", CASES)
def test_summarize_matches_jax(runs, case):
    J = jax_script("fullrun")
    cfg, eager, _ = runs[case]
    extra = {"scan_stepping": False, "overrides": {"stall_improve": 0.01}}
    got = fullrun.summarize(case, eager, cfg, 12.345, {}, "cpu", dict(extra))
    ref = J.summarize(case, eager, cfg, 12.345, {}, "cpu", dict(extra))
    skip = {"deck", "platform", "hostname"}
    assert {k: v for k, v in got.items() if k not in skip} \
        == {k: v for k, v in ref.items() if k not in skip}
    assert got["n_steps"] == 2
    if case == "case1":
        assert got["sane"]
    else:
        # 5 ms of heating leave T_max below sane's 320 K
        assert "min_quality_ratio" in got and got["recession_monotone"]
    # a wall that was not recorded stays null
    assert fullrun.summarize(case, eager, cfg, None, {}, "cpu",
                             {})["ms_per_step"] is None


@pytest.mark.parametrize("case", CASES)
def test_compare_case_matches_jax(runs, case):
    J = jax_script("oracle_compare")
    _, eager, scan = runs[case]
    got = oracle_compare.compare_case(case, eager, scan)
    ref = J.compare_case(case, eager, scan)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert got["probe_rel_rmse_max"] is not None
    if case == "case2_2":
        assert "pressure_probes" in got and "recession_at_overlap_end" in got


def test_main_runs_and_summarizes(tmp_path):
    """``main`` on the CPU: a 2-step case-1 run (eager) with its artifact,
    then --summarize-only from the same CSVs."""
    out = tmp_path / "c1"
    art_path = tmp_path / "art.json"
    rc = fullrun.main(["case1", "--cpu", "--eager", "--t-final", "0.2",
                       "--out-dir", str(out), "--artifact", str(art_path)])
    art = json.loads(art_path.read_text())
    assert rc == 0 and art["sane"] and art["n_steps"] == 2
    assert art["platform"] == "cpu" and art["dtype"] == "float64"
    assert art["scan_stepping"] is False and art["t_final"] == 0.2
    assert "schedule_end_s" not in art
    rc = fullrun.main(["case1", "--summarize-only", "--wall-s", "3.0",
                       "--out-dir", str(out)])
    part = json.loads((out / "fullrun_case1.json").read_text())
    assert rc == 0 and part["partial"] and part["wall_s"] == 3.0
    assert part["n_steps"] == art["n_steps"]
    assert part["T_max"] == art["T_max"]


def test_schedule_end_and_decks(tmp_path):
    """The 2.x decks name the schedule fixture, whose last row is the
    recorded ``schedule_end_s``; 2.2 runs on triangles at dt 0.0025."""
    from cmfem_tpu_torch.physics.surface_bc import SurfaceBCSchedule

    sched = SurfaceBCSchedule.load_file(fullrun.deck(
        "case2_1", str(tmp_path))["boundary_conditions_file"])
    assert sched.rows[-1, 0] == fullrun.SCHEDULE_END_S
    # past the last row the schedule holds it
    assert sched.eval(60.0) == sched.eval(fullrun.SCHEDULE_END_S)
    c22 = fullrun.deck("case2_2", str(tmp_path))
    assert c22["dt"] == 0.0025 and c22["t_final"] == 120.0
    assert "triangle" in c22["mesh_file"]
    assert "boundary_conditions_file" not in fullrun.deck("case1",
                                                          str(tmp_path))


def test_main_requires_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fullrun.main(["case1", "--t-final", "0.1", "--out-dir",
                      str(tmp_path)])
    assert not np.any([f.endswith(".json") for f in os.listdir(tmp_path)])
