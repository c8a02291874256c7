from .krylov import cg, gmres, SolveResult
from .precond import (
    jacobi_preconditioner,
    chebyshev_preconditioner,
    chebyshev_smooth,
    power_iteration_lmax,
)

__all__ = [
    "cg",
    "gmres",
    "SolveResult",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "chebyshev_smooth",
    "power_iteration_lmax",
]
