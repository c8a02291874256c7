"""Krylov solvers: preconditioned CG and restarted GMRES.

Port of ``cmfem_tpu/solvers/krylov.py`` with unchanged semantics.  Each
``lax.while_loop``/``lax.cond`` becomes a host loop or ``if``, so every
convergence test is one device-to-host sync.  GMRES keeps its small
Hessenberg/Givens state (R, g, cs, sn) in host numpy arrays of the working
dtype; the Krylov basis and all length-n vectors stay on b's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.timing import host_sync


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


def neumaier_dot(a, b, chunks: int = 256):
    """Compensated (Neumaier/Kahan) dot product, as
    ``cmfem_tpu.solvers.krylov.neumaier_dot``: products in the working
    dtype, ``chunks`` partial sums by the fast reduction, and the partials
    combined by a sequential Neumaier compensation (a host loop here, a
    ``lax.scan`` there) -- accumulation error O(eps) instead of
    O(eps sqrt(chunks)); the products' own rounding remains.  Pass as
    ``cg(..., dot=neumaier_dot)``.  The partials are read back once and
    compensated in numpy scalars of the working dtype (the same IEEE sums
    as on the device, without a launch per operation); the result is a
    0-d tensor on the inputs' device."""
    p = a.reshape(-1) * b.reshape(-1)
    n = p.shape[0]
    c = min(chunks, n)
    p = torch.nn.functional.pad(p, (0, (-n) % c)).reshape(c, -1)
    partials = torch.sum(p, dim=1).cpu().numpy()
    s = comp = partials.dtype.type(0)
    for v in partials:
        t = s + v
        comp = comp + ((s - t) + v if abs(s) >= abs(v) else (v - t) + s)
        s = t
    return torch.as_tensor(s + comp, device=p.device)


def cg(apply_A: Callable, b, x0=None, M: Callable | None = None,
       rtol=1e-12, atol=0.0, maxiter=1000,
       dot: Callable | None = None, stall_window: int = 64,
       norm: Callable | None = None) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    As ``cmfem_tpu.solvers.krylov.cg``: convergence, stagnation and the
    reported residual are anchored on explicitly computed true residuals
    ``b - A x``.  Every ``stall_window/2`` iterations the recursive residual
    is replaced by the true one, and the loop exits on DETACHMENT (two
    consecutive checkpoints whose true residual is >4x the recursive one)
    or on a FLAT WINDOW (no 10%-below-best improvement for
    ``stall_window`` iterations while the latest true residual sits within
    2x of the best).  ``stall_window=0`` disables both, and the
    checkpoints.

    ``dot`` and ``norm`` (default ``torch.dot`` and
    ``torch.linalg.vector_norm``) are the inner product and the 2-norm of
    the vectors' layout: a distributed operator whose ranks each hold a
    slab passes its own, reduced over the ranks, so that every rank takes
    the same tolerance and leaves the loop at the same iteration (a
    deviation: the JAX package's reductions are global by construction)."""
    x0 = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    M = M or _identity
    dot = dot or torch.dot
    norm = norm or torch.linalg.vector_norm
    window = int(stall_window) if stall_window else (maxiter + 1)
    check = max(1, window // 2) if stall_window else (maxiter + 2)

    r = (b - apply_A(x0)).to(b.dtype)
    z = M(r).to(b.dtype)
    rz = dot(r, z)
    bnorm = norm(b)
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
    rnorm = norm(b - apply_A(x))
    converged = bool(rnorm <= torch.sqrt(tol2) + 1e-300)
    stagnated = (not converged) and (detach >= 2 or flat()
                                     or bool(rr <= tol2))
    rel = rnorm / torch.clamp(bnorm, min=1e-300)
    return SolveResult(x, k, float(rnorm), converged, stagnated=stagnated,
                       rel_residual=float(rel))


def gmres(apply_A: Callable, b, x0=None, M: Callable | None = None,
          rtol=1e-12, atol=0.0, restart=50, maxiter=20,
          reduce: Callable | None = None) -> SolveResult:
    """Restarted GMRES(m) with left preconditioning.

    maxiter counts outer restarts; total Krylov iterations <= restart*maxiter.
    As ``cmfem_tpu.solvers.krylov.gmres``: progressive Givens QR (so
    post-breakdown noise columns never enter the triangular solve), the
    tolerance clamped at 16 eps |M b| (the working-precision floor), and
    an exit when a full cycle improves the true residual by < 10%.

    ``reduce`` sums a tensor of partial sums over the ranks (for example
    ``DeviceMesh.all_reduce``): vectors that are slabs of a distributed
    layout pass it, and every inner product and norm becomes the sum of
    the ranks' local ones.  Each Gram-Schmidt pass reduces its
    ``restart + 1`` products in one call, and each norm in one more, so
    that every rank takes the same decisions (a deviation: the JAX
    package's reductions are global by construction).  Without it the
    vectors are whole and the reductions local, as before."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    host = dict(dtype=dtype, device="cpu")
    tiny = torch.finfo(dtype).tiny
    x0 = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    M = M or _identity
    if reduce is None:
        norm, project = torch.linalg.vector_norm, torch.matmul
    else:
        norm = lambda v: torch.sqrt(reduce(torch.dot(v, v)))
        project = lambda V, w: reduce(V @ w)

    bnorm = norm(M(b))
    eps = torch.finfo(dtype).eps
    host_sync()
    tol = torch.maximum(torch.clamp(rtol * bnorm, min=atol),
                        16.0 * eps * bnorm).cpu()
    m = restart

    npdt = torch.empty((), dtype=dtype).numpy().dtype
    tol_h = tol.numpy()

    def restart_cycle(x, r):
        beta = norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = torch.where(beta > tiny, r / beta, r)
        # the Givens state in numpy scalars of the working dtype: the same
        # IEEE products and sums as torch's, at a fraction of the host cost
        # of 0-d tensor ops
        R = np.zeros((m + 1, m), dtype=npdt)
        g = np.zeros(m + 1, dtype=npdt)
        host_sync()
        g[0] = beta.cpu().numpy()
        cs = np.zeros(m, dtype=npdt)
        sn = np.zeros(m, dtype=npdt)
        j, res = 0, g[0]
        while j < m and res > tol_h:
            w = M(apply_A(V[j]))
            # modified Gram-Schmidt against the masked basis, twice
            mask = (torch.arange(m + 1, device=dev) <= j).to(dtype)
            h = project(V, w) * mask
            w = w - V.T @ h
            h2 = project(V, w) * mask
            w = w - V.T @ h2
            h = h + h2
            hj1 = norm(w)
            V[j + 1] = torch.where(hj1 > tiny, w / hj1, torch.zeros_like(w))
            host_sync(2)
            h = h.cpu().numpy()
            h[j + 1] = hj1.cpu().numpy()
            # apply the previous rotations to the new column
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hi1
            # new rotation annihilating h[j+1], in torch's ops (torch.sqrt
            # and numpy's differ in the last bit of some values)
            h0, h1 = torch.from_numpy(h[j:j + 2].copy())
            denom = torch.sqrt(h0 ** 2 + h1 ** 2)
            ok = bool(denom > tiny)
            c = h0 / torch.clamp(denom, min=tiny) if ok else 1.0
            s = h1 / torch.clamp(denom, min=tiny) if ok else 0.0
            h[j], h[j + 1] = denom, 0.0
            cs[j], sn[j] = c, s
            R[:, j] = h
            g[j], g[j + 1] = cs[j] * g[j], -sn[j] * g[j]
            j += 1
            res = abs(g[j])
        R, g = torch.from_numpy(R), torch.from_numpy(g)
        # triangular solve over the j active columns; inactive columns and
        # active ~zero pivots (exact breakdown) get a unit diagonal and a
        # zero rhs so y vanishes there
        usable = (torch.arange(m) < j) & (R[:m, :m].diagonal().abs() > tiny)
        Rsolve = R[:m, :m] + torch.diag(torch.where(usable, 0.0, 1.0)
                                        .to(dtype))
        gg = torch.where(usable, g[:m], 0.0)
        y = torch.linalg.solve_triangular(Rsolve, gg[:, None], upper=True)
        host_sync()   # y, on the host, to the device
        x_new = x + V[:m].T @ y[:, 0].to(dev)
        # explicit (not Givens-estimated) residual; also the next cycle's
        # starting vector
        r_new = M(b - apply_A(x_new))
        host_sync()
        return x_new, r_new, norm(r_new).cpu(), j

    r = M(b - apply_A(x0)).to(dtype)
    x = x0
    host_sync()
    res = norm(r).cpu()
    prev = torch.tensor(float("inf"), **host)
    k = ki = 0
    # stop on convergence, the cycle cap, or stagnation (NaN exits too)
    while k < maxiter and bool(res > tol) and bool(res < 0.9 * prev):
        x, r, res_new, k_in = restart_cycle(x, r)
        prev, res = res, res_new
        k += 1
        ki += k_in
    stagnated = bool(res > tol) and not bool(res < 0.9 * prev)
    host_sync()
    relres = res / torch.clamp(bnorm.cpu(), min=tiny)
    return SolveResult(x, k, float(res), bool(res <= tol), ki, stagnated,
                       float(relres))
