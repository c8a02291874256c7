"""Port parity, ``cmfem_tpu_torch.scripts.blocksolve_refinement``, at refine
1 of the 3 x 20 strip: the checks of ``test_torch_scripts_refinement.py``
(``torch_scripts_helpers.refinement_parity``) on the refined systems."""

from torch_ablation_helpers import one_torch_thread  # noqa: F401
from torch_scripts_helpers import refinement_parity

from cmfem_tpu_torch.scripts import common


def test_refined_states_and_solves_match_jax(tmp_path):
    refinement_parity(common.strip_file(str(tmp_path), 3, 20), 1)
