from .assembly import SpaceOps, OperatorData, BilinearForm
from .bc import EssentialBC

__all__ = ["SpaceOps", "OperatorData", "BilinearForm", "EssentialBC"]
