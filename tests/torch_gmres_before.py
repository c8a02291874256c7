"""The port's restarted GMRES as it stood before the ``reduce`` hook and
the numpy Givens state (``cmfem_tpu_torch/solvers/krylov.py`` of slice
11), kept verbatim as the reference that ``test_torch_krylov_reduce``
holds the present one to, bit for bit."""

from typing import Callable

import torch

from cmfem_tpu_torch.solvers.krylov import SolveResult, _identity


def gmres(apply_A: Callable, b, x0=None, M: Callable | None = None,
          rtol=1e-12, atol=0.0, restart=50, maxiter=20) -> SolveResult:
    """Restarted GMRES(m) with left preconditioning.

    maxiter counts outer restarts; total Krylov iterations <= restart*maxiter.
    As ``cmfem_tpu.solvers.krylov.gmres``: progressive Givens QR (so
    post-breakdown noise columns never enter the triangular solve), the
    tolerance clamped at 16 eps |M b| (the working-precision floor), and
    an exit when a full cycle improves the true residual by < 10%."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    host = dict(dtype=dtype, device="cpu")
    tiny = torch.finfo(dtype).tiny
    x0 = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    M = M or _identity

    bnorm = torch.linalg.vector_norm(M(b))
    eps = torch.finfo(dtype).eps
    tol = torch.maximum(torch.clamp(rtol * bnorm, min=atol),
                        16.0 * eps * bnorm).cpu()
    m = restart

    def restart_cycle(x, r):
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = torch.where(beta > tiny, r / beta, r)
        R = torch.zeros((m + 1, m), **host)
        g = torch.zeros(m + 1, **host)
        g[0] = beta.cpu()
        cs = torch.zeros(m, **host)
        sn = torch.zeros(m, **host)
        j, res = 0, g[0].clone()
        while j < m and bool(res > tol):
            w = M(apply_A(V[j]))
            # modified Gram-Schmidt against the masked basis, twice
            mask = (torch.arange(m + 1, device=dev) <= j).to(dtype)
            h = (V @ w) * mask
            w = w - V.T @ h
            h2 = (V @ w) * mask
            w = w - V.T @ h2
            h = h + h2
            hj1 = torch.linalg.vector_norm(w)
            V[j + 1] = torch.where(hj1 > tiny, w / hj1, torch.zeros_like(w))
            h = h.cpu()
            h[j + 1] = hj1.cpu()
            # apply the previous rotations to the new column
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hi1
            # new rotation annihilating h[j+1]
            denom = torch.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            ok = bool(denom > tiny)
            c = h[j] / torch.clamp(denom, min=tiny) if ok else 1.0
            s = h[j + 1] / torch.clamp(denom, min=tiny) if ok else 0.0
            h[j], h[j + 1] = denom, 0.0
            cs[j], sn[j] = c, s
            R[:, j] = h
            g[j], g[j + 1] = c * g[j], -s * g[j]
            j += 1
            res = g[j].abs()
        # triangular solve over the j active columns; inactive columns and
        # active ~zero pivots (exact breakdown) get a unit diagonal and a
        # zero rhs so y vanishes there
        usable = (torch.arange(m) < j) & (R[:m, :m].diagonal().abs() > tiny)
        Rsolve = R[:m, :m] + torch.diag(torch.where(usable, 0.0, 1.0)
                                        .to(dtype))
        gg = torch.where(usable, g[:m], 0.0)
        y = torch.linalg.solve_triangular(Rsolve, gg[:, None], upper=True)
        x_new = x + V[:m].T @ y[:, 0].to(dev)
        # explicit (not Givens-estimated) residual; also the next cycle's
        # starting vector
        r_new = M(b - apply_A(x_new))
        return x_new, r_new, torch.linalg.vector_norm(r_new).cpu(), j

    r = M(b - apply_A(x0)).to(dtype)
    x = x0
    res = torch.linalg.vector_norm(r).cpu()
    prev = torch.tensor(float("inf"), **host)
    k = ki = 0
    # stop on convergence, the cycle cap, or stagnation (NaN exits too)
    while k < maxiter and bool(res > tol) and bool(res < 0.9 * prev):
        x, r, res_new, k_in = restart_cycle(x, r)
        prev, res = res, res_new
        k += 1
        ki += k_in
    stagnated = bool(res > tol) and not bool(res < 0.9 * prev)
    relres = res / torch.clamp(bnorm.cpu(), min=tiny)
    return SolveResult(x, k, float(res), bool(res <= tol), ki, stagnated,
                       float(relres))
