"""Analytic/manufactured solutions used by the verification drivers.

Copy of ``cmfem_tpu/physics/exact_solutions.py`` (numpy), with one change:
``nonlinear_heat_exact`` takes its array module from ``x``, so the series is
evaluated where the points are (numpy nodes for ``FESpace.interpolate``,
device tensors at the quadrature points of the error norms and the Neumann
flux) and nothing is copied to the host per call."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class NonlinearHeatParams:
    """Constants of the nonlinear-heat series solution
    (nonlinear_convection_diffusion_1D.cpp:91-102)."""

    alpha: float = 2.5e-6
    kappa1: float = 10.0
    kappa2: float = 100.0
    T0: float = 300.0
    T1: float = 300.0
    T2: float = 1300.0
    qbar: float = 7.5e5
    L: float = 1.0
    series_terms: int = 400


def nonlinear_heat_exact(x, t, p: NonlinearHeatParams):
    """u(x,t) and u_x(x,t) of the Kirchhoff-transformed nonlinear heat
    problem (series solution, reference :324-368).  Vectorized in x: a
    tensor x gives tensors on its device (float64 arithmetic, cast back to
    x's dtype), anything else float64 numpy arrays."""
    if torch.is_tensor(x):
        xp, out_dtype = torch, x.dtype
        x = x.to(torch.float64)
        n = torch.arange(1, p.series_terms + 1, dtype=torch.float64,
                         device=x.device)
        clamp = lambda v: torch.clamp(v, min=1.0e-14)
    else:
        xp, out_dtype = np, None
        x = np.asarray(x, dtype=np.float64)
        n = np.arange(1, p.series_terms + 1, dtype=np.float64)
        clamp = lambda v: np.maximum(1.0e-14, v)
    L = p.L
    inv_L = 1.0 / L
    inv_L2 = inv_L * inv_L
    pi = math.pi
    decay = xp.exp(-(n**2) * (pi**2 * p.alpha * t * inv_L2))
    arg = xp.outer(x, n) * (pi * inv_L)  # (npts, nterms)
    sum_cos = (decay / n**2 * xp.cos(arg)).sum(axis=1)
    sum_sin = (decay / n * xp.sin(arg)).sum(axis=1)

    f = (p.alpha * t * inv_L2 + 1.0 / 3.0 - x * inv_L + 0.5 * x**2 * inv_L2
         - 2.0 / pi**2 * sum_cos)
    fx = -inv_L + x * inv_L2 + 2.0 / (pi * L) * sum_sin

    theta0 = (p.T0 - p.T1) + (p.kappa2 - p.kappa1) / (p.T2 - p.T1) / (2.0 * p.kappa1) \
        * (p.T0 - p.T1) ** 2
    theta = f * p.qbar * L / p.kappa1 + theta0
    gamma = 2.0 * (p.kappa2 - p.kappa1) / ((p.T2 - p.T1) * p.kappa1)
    sqrt_val = xp.sqrt(clamp(1.0 + gamma * theta))
    u = p.T1 + (p.T2 - p.T1) * (p.kappa1 / (p.kappa2 - p.kappa1)) * (-1.0 + sqrt_val)
    theta_x = p.qbar * L / p.kappa1 * fx
    ux = theta_x / sqrt_val
    if out_dtype is not None:
        return u.to(out_dtype), ux.to(out_dtype)
    return u, ux
