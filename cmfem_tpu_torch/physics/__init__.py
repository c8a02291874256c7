from .exact_solutions import NonlinearHeatParams, nonlinear_heat_exact

__all__ = ["NonlinearHeatParams", "nonlinear_heat_exact"]
