"""YAML configuration loading with the reference's conventions.

Copy of ``cmfem_tpu/utils/yamlcfg.py``.  The reference parses YAML
key-by-key with defaults-in-struct and validation-with-throw; ``load_yaml``
additionally records the YAML's own directory so that data-file paths
resolve relative to it and the reference's Input/*.yaml files work from any
CWD.  PyYAML is imported inside ``load_yaml`` only: a driver run from a
``cfg`` dict needs none.
"""

from __future__ import annotations

import os


def load_yaml(path: str) -> dict:
    if not path:
        raise ValueError("Input YAML file path is empty.")
    if not os.path.exists(path):
        raise FileNotFoundError(f"YAML input file not found: {path}")
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(
            f"YAML input must be a mapping of config keys, got "
            f"{type(data).__name__}: {path}")
    data["_yaml_dir"] = os.path.dirname(os.path.abspath(path))
    return data


def cfg_get(cfg: dict, key: str, default=None, required: bool = False):
    if key in cfg:
        return cfg[key]
    if required:
        raise KeyError(f"Missing required YAML key: {key}")
    return default


def resolve_path(cfg: dict, p: str) -> str:
    """Resolve a data path: as-is if it exists, else relative to the YAML
    dir, else relative to the YAML dir's parent (reference layout has
    Input/ and Mesh/ as siblings)."""
    if os.path.exists(p):
        return p
    base = cfg.get("_yaml_dir", ".")
    for cand in (os.path.join(base, p), os.path.join(os.path.dirname(base), p)):
        if os.path.exists(cand):
            return cand
    return p
