"""Preconditioners: Jacobi and Chebyshev polynomial.

Port of ``cmfem_tpu/solvers/precond.py``.  ``power_iteration_lmax`` takes a
``torch.Generator`` where the JAX version took a PRNG key; the two give
different start vectors from the same seed."""

from __future__ import annotations

from typing import Callable

import torch


def jacobi_preconditioner(diag) -> Callable:
    """M^{-1} = diag(A)^{-1}; tolerant of constrained identity rows."""
    d = torch.as_tensor(diag)
    inv = torch.where(d.abs() > 1e-300, 1.0 / d, 1.0)

    def M(r):
        return inv * r

    return M


def power_iteration_lmax(apply_A: Callable, n: int, iters: int = 30,
                         generator: torch.Generator | None = None, *,
                         device, dtype=torch.float64):
    """Estimate the largest eigenvalue of A (SPD) by power iteration.

    The start vector is drawn on the CPU from ``generator`` (default: a
    generator seeded with 0) and moved to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(n, generator=generator, dtype=dtype).to(device)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        w = apply_A(v)
        lam = torch.dot(v, w)
        nw = torch.linalg.vector_norm(w)
        v = torch.where(nw > 0, w / nw, v)
    return lam


def chebyshev_smooth(Aop: Callable, rs, lmax, degree: int, lmin=None):
    """z ~= A^{-1} rs via the Chebyshev iteration with z0 = 0 on
    [lmin, lmax] (lmin defaults to the lmax/30 smoothing heuristic)."""
    # python numbers become float64 0-dim tensors, which never demote rs
    f64 = lambda v: v if torch.is_tensor(v) else torch.tensor(
        float(v), dtype=torch.float64, device=rs.device)
    lmax = f64(lmax)
    lmin = lmax / 30.0 if lmin is None else f64(lmin)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    z = rs / theta
    d = z
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        # d_{k+1} = rho_{k+1} rho_k d_k + (2 rho_{k+1}/delta)(rs - A z_k)
        d = rho_new * (2.0 / delta * (rs - Aop(z)) + rho * d)
        z = z + d
        rho = rho_new
    return z


def chebyshev_preconditioner(apply_A: Callable, lmax, lmin=None,
                             degree: int = 4, diag=None) -> Callable:
    """Chebyshev polynomial approximation of A^{-1} on [lmin, lmax].

    With `diag` given, preconditions the Jacobi-scaled operator
    D^{-1} A (the standard matrix-free smoother construction)."""
    if diag is not None:
        dinv = 1.0 / torch.as_tensor(diag)

        def Aop(x):
            return dinv * apply_A(x)
    else:
        dinv = None
        Aop = apply_A

    def M(r):
        if dinv is not None:
            r = dinv * r
        return chebyshev_smooth(Aop, r, lmax, degree, lmin)

    return M
