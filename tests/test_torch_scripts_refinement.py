"""Port parity, ``cmfem_tpu_torch.scripts.blocksolve_refinement``: on a 3 x
20 strip at refine 0 (refine 1 in ``..._refinement_refined.py``), the port's ``make_states`` equals the JAX
script's on the same mesh (1e-12), its Newton systems equal the JAX
study's (residual 1e-9 of max|R|, blocks 1e-12), and for each state and
preconditioner the port's GMRES takes the JAX ``BlockNewtonKrylov``'s
restart cycles and inner iterations at the study's rtol 1e-6 and at 1e-10,
with the direction equal to JAX's to 1e-8, except the point blocks' at
1e-6: there the p field of this system (a 1e9 scale disparity) is fixed
only to the solver's tolerance, and two runs whose systems differ in
roundoff land 3.8e-6 apart at equal counts (at 1e-10, ~1e-10).  The
study's record carries the JAX artifact's keys."""

import json
import os

import pytest
import torch

from torch_ablation_helpers import one_torch_thread  # noqa: F401
from torch_scripts_helpers import ROOT, refinement_parity

from cmfem_tpu_torch.scripts import blocksolve_refinement as P
from cmfem_tpu_torch.scripts import common


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    return common.strip_file(str(tmp_path_factory.mktemp("strip")), 3, 20)


def test_states_and_solves_match_jax(strip):
    refinement_parity(strip, 0)


def test_study_record_has_the_jax_keys(tmp_path):
    """The port's study at refine 0 of a 3 x 20 strip: JAX's keys at every
    level of the record (those of the JAX artifact), the port's additions,
    and a partial JSON flushed after the level."""
    out = P.run_study((0,), device="cpu", out_dir=str(tmp_path), nx=3,
                      ny=20)
    with open(os.path.join(ROOT, "artifacts_blocksolve_refinement."
                           "partial.json")) as f:
        jax_rec = json.load(f)
    assert set(jax_rec) - {"levels"} <= set(out)
    assert "linemg_growth" in out
    jl, pl = jax_rec["levels"][0], out["levels"][0]
    assert set(jl) <= set(pl)
    assert {"nxs", "NY", "NX", "peak_gib"} <= set(pl)
    assert pl["ndofs_tp"] == 2 * 4 * 21 and pl["nxs"] == [4, 2, 1]
    for name, st in jl["states"].items():
        assert st["branch"] == pl["states"][name]["branch"]
        for pc in ("linemg", "pointblock"):
            assert set(st[pc]) <= set(pl["states"][name][pc])
            assert pl["states"][name][pc]["converged"]
            # the CPU runs the plain versions: no kernel launch
            assert pl["states"][name][pc]["launches_solve"] == 0
    assert out["linemg_growth"]["heating"][
        "linemg_inner_iters_by_level"] == [
        pl["states"]["heating"]["linemg"]["inner_iters"]]
    with open(tmp_path / "blocksolve_refinement.partial.json") as f:
        assert json.load(f)["levels"][0]["refine"] == 0


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(["0", "--nx", "3", "--ny", "20", "--out-dir", str(tmp_path)])
