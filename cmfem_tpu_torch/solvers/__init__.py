from .krylov import cg, gmres, SolveResult
from .precond import (
    jacobi_preconditioner,
    chebyshev_preconditioner,
    chebyshev_smooth,
    power_iteration_lmax,
)
from .multigrid import GeometricMG, StructuredMG
from .direct import dense_solve, dense_factor, dense_apply_factor
from .newton import NewtonConfig, NewtonResult, newton_solve
from .timeint import DIRKTableau, get_tableau, make_linear_dirk_step, stage_times

__all__ = [
    "cg",
    "gmres",
    "SolveResult",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "chebyshev_smooth",
    "power_iteration_lmax",
    "dense_solve",
    "dense_factor",
    "dense_apply_factor",
    "NewtonConfig",
    "NewtonResult",
    "newton_solve",
    "StructuredMG",
    "GeometricMG",
    "DIRKTableau",
    "get_tableau",
    "make_linear_dirk_step",
    "stage_times",
]
