"""chip_smoke phase 16 (``chip_smoke.run_scripts``) rehearsed on the CPU at
a small size: the refinement study at refine 0 of a 3 x 20 strip with both
preconditioners and both states, ``fullrun case1 --eager --t-final 0.3``
through the module's ``main`` (its 11 x 239 deck), the compensated-dot CG
at N = 4; every solve converges, the run is ``sane``, and on the CPU no
line kernel is launched (the wrappers run their plain versions)."""

import os
import sys

from torch_ablation_helpers import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_run_scripts_on_cpu(tmp_path):
    chip_smoke.reset_counts()
    rec = chip_smoke.run_scripts("cpu", str(tmp_path), nx=3, ny=20,
                                 n_dots=4)
    assert not any(chip_smoke.counts().values()), chip_smoke.counts()
    lv = rec["refinement_refine0"]
    assert lv["ndofs_tp"] == 2 * 4 * 21 and lv["peak_gib"] is None
    for st in lv["states"].values():
        for pc in ("linemg", "pointblock"):
            assert st[pc]["converged"] and st[pc]["launches_solve"] == 0
    assert rec["fullrun_case1"]["sane"]
    assert rec["fullrun_case1"]["n_steps"] == 3
    assert rec["compensated_dots"]["ndofs"] == (2 * 4 + 1) ** 3
