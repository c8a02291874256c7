from .yamlcfg import load_yaml, cfg_get
from .timing import StepTimer

__all__ = ["load_yaml", "cfg_get", "StepTimer"]
