"""Krylov solvers: preconditioned CG and restarted GMRES.

Port of ``cmfem_tpu/solvers/krylov.py`` with unchanged semantics.  Each
``lax.while_loop``/``lax.cond`` becomes a host loop or ``if``, so every
convergence test is one device-to-host sync.  GMRES keeps its small
Hessenberg/Givens state (R, g, cs, sn) in host tensors of the working
dtype; the Krylov basis and all length-n vectors stay on b's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float  # final explicit residual norm (GMRES: of M r)
    converged: bool
    # total inner Krylov iterations (GMRES: Arnoldi steps summed over
    # restart cycles); -1 marks "not tracked" (CG)
    inner_iters: int = -1
    # stopped above tol on a working-precision floor signal (see
    # cmfem_tpu.solvers.krylov.SolveResult)
    stagnated: bool = False
    # final residual norm relative to |b| (CG) or |M b| (GMRES)
    rel_residual: float = -1.0


def _identity(x):
    return x


def cg(apply_A: Callable, b, x0=None, M: Callable | None = None,
       rtol=1e-12, atol=0.0, maxiter=1000,
       dot: Callable | None = None, stall_window: int = 64) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    As ``cmfem_tpu.solvers.krylov.cg``: convergence, stagnation and the
    reported residual are anchored on explicitly computed true residuals
    ``b - A x``.  Every ``stall_window/2`` iterations the recursive residual
    is replaced by the true one, and the loop exits on DETACHMENT (two
    consecutive checkpoints whose true residual is >4x the recursive one)
    or on a FLAT WINDOW (no 10%-below-best improvement for
    ``stall_window`` iterations while the latest true residual sits within
    2x of the best).  ``stall_window=0`` disables both, and the
    checkpoints."""
    x0 = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    M = M or _identity
    dot = dot or torch.dot
    window = int(stall_window) if stall_window else (maxiter + 1)
    check = max(1, window // 2) if stall_window else (maxiter + 2)

    r = (b - apply_A(x0)).to(b.dtype)
    z = M(r).to(b.dtype)
    rz = dot(r, z)
    bnorm = torch.linalg.vector_norm(b)
    tol2 = torch.clamp(rtol * bnorm, min=atol) ** 2
    x, p = x0, z
    rr = dot(r, r)
    k, kbest, detach = 0, 0, 0
    rr_best = rr_true = rr_true_best = rr

    def flat():
        # no new minimum for a full window AND the latest TRUE residual
        # sits near the best TRUE value: a converged-flat floor
        return (k - kbest >= window) and bool(rr_true <= 4.0 * rr_true_best)

    while k < maxiter and bool(rr > tol2) and detach < 2 and not flat():
        Ap = apply_A(p).to(b.dtype)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_rec = dot(r, r)
        # residual replacement at checkpoints
        do_check = (k + 1) % check == 0
        if do_check:
            r = (b - apply_A(x)).to(b.dtype)
        z = M(r).to(b.dtype)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rr = dot(r, r)           # true rr at checkpoints, recursive else
        if do_check:
            detach = detach + 1 if bool(rr > 16.0 * rr_rec) else 0
            rr_true = rr
            rr_true_best = torch.minimum(rr, rr_true_best)
        if bool(rr < 0.81 * rr_best):  # 10% in norm = 19% in norm^2
            kbest = k + 1
        rr_best = torch.minimum(rr, rr_best)
        rz = rz_new
        k += 1

    # explicit final residual: the recursive r under-reports in f32
    rnorm = torch.linalg.vector_norm(b - apply_A(x))
    converged = bool(rnorm <= torch.sqrt(tol2) + 1e-300)
    stagnated = (not converged) and (detach >= 2 or flat()
                                     or bool(rr <= tol2))
    rel = rnorm / torch.clamp(bnorm, min=1e-300)
    return SolveResult(x, k, float(rnorm), converged, stagnated=stagnated,
                       rel_residual=float(rel))


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
