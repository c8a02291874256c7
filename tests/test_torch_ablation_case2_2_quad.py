"""Port parity, the case-2.2 study variant (``ablation_case2_2_test``: GCL
storage on, the Amaryllis recession metrics) on a 3 x 20 graded QUAD
strip: both packages' eager ``run`` with the synthetic TACOT deck and B'
table, the schedule fixture ``surface_bc_case21.dat`` and the synthetic
Amaryllis mass history, 3 steps of dt 0.1 on the chemistry-blowing branch
(the mesh recedes every step), float64 on the CPU.  The JAX eager driver
runs once; the port's host-LU and ``gmres`` (linear_rtol 1e-12) runs match
its eight CSVs to rtol 1e-7 with equal Newton counts, its
recession_error_metrics.csv to 1e-12, its vertices to 1e-12 (of the
largest coordinate) and its total recession to 1e-8 relative.  The scan
path refuses a quad strip at its tracked samplers in the JAX words, as the
JAX scan path does."""

import numpy as np
import pytest

from torch_ablation_helpers import (  # noqa: F401
    CSVS22 as CSVS, case22_cfg, hold_to_jax, newton_counts, one_torch_thread,
    strip_file)

MODES = {"lu": {}, "gmres": {"linear_solver": "gmres", "linear_rtol": 1e-12}}


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    return strip_file(tmp_path_factory.mktemp("mesh"), 3, 20, "quad")


@pytest.fixture(scope="module")
def runs(strip, tmp_path_factory):
    from cmfem_tpu.apps import ablation_case2_2_test as J
    from cmfem_tpu_torch.apps import ablation_case2_2_test as P

    d = tmp_path_factory.mktemp("runs")
    out = {"dir": d, "jax": J.run(case22_cfg(strip, d / "jax",
                                             t_final=0.3))}
    for mode, extra in MODES.items():
        out[mode] = P.run(case22_cfg(strip, d / mode, t_final=0.3, **extra),
                          device="cpu")
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_study_variant_on_quads_matches_jax(runs, mode):
    d = runs["dir"]
    floor, newton_rtol = (1e-9, 1e-6) if mode == "gmres" else (1e-12, 1e-7)
    hold_to_jax(d / mode, d / "jax", floor=floor, newton_rtol=newton_rtol)
    port, jax_ = runs[mode], runs["jax"]
    assert port["newton_iters"] == newton_counts(d / "jax" / CSVS[3]) \
        and len(port["newton_iters"]) == 3
    v = np.asarray(jax_["vertices"])
    assert np.abs(port["vertices"] - v).max() <= 1e-12 * np.abs(v).max()
    assert abs(port["recession_total"] - jax_["recession_total"]) <= \
        1e-8 * jax_["recession_total"]
    assert port["moved"] == [True] * 3 and port["recession_total"] > 0
    np.testing.assert_allclose(port["T"], jax_["T"], rtol=1e-9)
    for k, val in jax_["recession_metrics"].items():
        assert port["recession_metrics"][k] == pytest.approx(val, rel=1e-12)


def test_scan_refuses_a_quad_strip_as_jax(strip, tmp_path):
    from cmfem_tpu.apps import ablation_case2_2 as J
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    msgs = []
    for name, run in (("jax", J.run),
                      ("port", lambda cfg: P.run(cfg, device="cpu"))):
        with pytest.raises(NotImplementedError, match="triangle") as e:
            run(case22_cfg(strip, tmp_path / name, t_final=0.1,
                           scan_stepping=True))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "TrackedSampler supports order-1 triangle meshes"
