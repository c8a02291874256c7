from .assembly import (
    SpaceOps,
    OperatorData,
    BilinearForm,
    domain_lf,
    boundary_lf,
    supg_lf,
    l2_error,
    l2_norm_fn,
    weighted_l2_error,
    linf_error,
)
from .bc import EssentialBC

__all__ = ["SpaceOps", "OperatorData", "BilinearForm", "EssentialBC",
           "domain_lf", "boundary_lf", "supg_lf", "l2_error", "l2_norm_fn",
           "weighted_l2_error", "linf_error"]
