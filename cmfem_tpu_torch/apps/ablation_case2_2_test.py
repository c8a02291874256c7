"""Self-checking ablation-study variant of case 2.2.

Port of ``cmfem_tpu/apps/ablation_case2_2_test.py`` (the reference's
ablation_test_case2_2_2D_test.cpp): the production driver with the study
features on by default: the per-term ALE toggles (``ale_mass_enabled``,
``ale_energy_solid_enabled``, ``ale_energy_gas_enabled``, :120-123), the
Jacobian-weighted (J_old/J_new per QP) geometric-conservation storage
terms (``gcl_storage_enabled``, EvaluateQPCoeffs :1678-1775) and the
Amaryllis recession-history metrics (:302-460, written to
recession_error_metrics.csv when ``amaryllis_mass_file`` is given).
"""

from __future__ import annotations

import sys

import torch

from .ablation_case2_2 import run as run_case2_2
from .common import device_from_env, echo_config, parse_args
from ..utils.yamlcfg import load_yaml

STUDY_DEFAULTS = {
    "gcl_storage_enabled": True,
    "ale_mass_enabled": True,
    "ale_energy_solid_enabled": True,
    "ale_energy_gas_enabled": True,
    "collection_name": "ablation_test_case2_2_2D_test",
    "output_path": "ParaView/ablation_case2_2_test",
}


def run(cfg: dict, device=None, dtype=torch.float64) -> dict:
    merged = dict(STUDY_DEFAULTS)
    merged.update(cfg)
    return run_case2_2(merged, device=device, dtype=dtype)


def main(argv=None):
    args = parse_args("Input/input_ablation_case2_2.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg, device=device_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
