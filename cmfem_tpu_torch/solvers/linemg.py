"""h-robust preconditioner for the coupled (T, p) strip Jacobians:
x-semicoarsened multigrid with exact y-line smoothing.

Port of ``cmfem_tpu/solvers/linemg.py``.  The point-block GMRES of
``solvers.blocksolve`` needs more iterations at every uniform refinement of
the strip; this preconditioner does not:

- **y-line smoothing**: the ablation strips are tall and thin and graded
  toward the heated top, so the dominant coupling is vertical.  Each
  smoothing step solves every x-column's block-tridiagonal (2x2 field
  blocks over NY rows) system exactly, batched over columns, by the same
  orthogonal (QR) elimination as ``BlockTridiagDirect``;
- **semicoarsening in x**: levels coarsen only the x (column) axis by 2,
  with linear interpolation and Galerkin (P^T A P) coarse operators, until
  one column remains, where the line solve is the exact coarse solve;
- everything acts on the canonical (3, 3, NY, NX, 2, 2) DIA stencil
  (|oy| <= 1, |ox| <= 1: order-1 quad and triangle strips).

The cycle is a fixed linear operator (static sweep counts), so it is a
valid left preconditioner for the non-flexible GMRES of ``solvers.krylov``;
``BlockNewtonKrylov(pc="linemg")`` uses it.  ``line_factor`` and
``line_solve`` (the block-QR elimination down every column's rows and its
two sweeps) are ``kernels.linemg``'s: on CUDA tensors hand-written kernels,
one launch a call (the JAX package's ``lax.scan``s as Python loops of tiny
launches took 9.4 s per factorization and 1.3 s per apply at 86,130 DOFs
on the H100); on CPU tensors their plain versions, the scans as
Python loops over the rows with ``torch.linalg.qr`` and
``torch.linalg.solve_triangular`` for ``jnp.linalg.qr`` and
``jax.scipy.linalg.solve_triangular``.  QR factors may differ in sign
between LAPACK, cuSOLVER and the kernel: compare solves, never factors.
"""

from __future__ import annotations

import torch

from ..kernels.linemg import line_factor, line_solve

_ORDER1 = "line-MG supports 3x3 stencils (order-1 strips) only"


def _pad(a, x=(0, 0), y=(0, 0)):
    """Zero-pad the y (dim 0) and x (dim 1) axes of a (Y, X, ...) tensor."""
    tail = (0, 0) * (a.dim() - 2)
    return torch.nn.functional.pad(a, tail + x + y)


def canonical_stencil(S, offs, NY, NX, mask2_lat, n):
    """(4, KO, NY, NX) DIA stencil -> canonical (3, 3, NY, NX, 2, 2).

    ``SS[oy+1, ox+1, y, x]`` is the 2x2 field block coupling row (y, x) to
    column (y+oy, x+ox).  Essential rows and columns are set to exact
    identity and zero (the assembled stencil carries summed per-element
    identity entries at essential DOFs; the hierarchy must see a clean
    identity).  Raises ValueError beyond the 3x3 offset footprint."""
    SS = torch.zeros((3, 3, NY, NX, 2, 2), dtype=S.dtype, device=S.device)
    for k, (oy, ox) in enumerate(offs):
        if abs(oy) > 1 or abs(ox) > 1:
            raise ValueError(_ORDER1)
        blk = torch.stack([torch.stack([S[0, k], S[1, k]], dim=-1),
                           torch.stack([S[2, k], S[3, k]], dim=-1)], dim=-2)
        SS[oy + 1, ox + 1] = blk
    # (NY, NX, 2): the field-f row (y, x) is essential
    mrow = torch.stack([mask2_lat[:n].reshape(NY, NX),
                        mask2_lat[n:].reshape(NY, NX)], dim=-1)
    mrow_f = mrow.to(S.dtype)
    keep_r = 1.0 - mrow_f
    mpad = _pad(mrow_f, (1, 1), (1, 1))
    eye = torch.eye(2, dtype=S.dtype, device=S.device)
    rows = []
    for oy in range(3):
        row = []
        for ox in range(3):
            keep_c = 1.0 - mpad[oy:oy + NY, ox:ox + NX]
            blk = SS[oy, ox] * keep_r[..., :, None] * keep_c[..., None, :]
            if oy == 1 and ox == 1:
                blk = blk + eye * mrow_f[..., :, None]
            row.append(blk)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def stencil_matvec(SS, z):
    """Apply the canonical stencil: z (NY, NX, 2) -> (NY, NX, 2)."""
    NY, NX = z.shape[0], z.shape[1]
    zp = _pad(z, (1, 1), (1, 1))
    out = torch.zeros_like(z)
    for oy in range(3):
        for ox in range(3):
            w = zp[oy:oy + NY, ox:ox + NX]
            out = out + torch.einsum("yxab,yxb->yxa", SS[oy, ox], w)
    return out


def line_residual(SS, x, r):
    """|A_line x - r| / |r| of the y-line systems: the ox = 0 blocks of the
    canonical stencil SS."""
    line = torch.zeros_like(SS)
    line[:, 1] = SS[:, 1]
    return float(torch.linalg.vector_norm(stencil_matvec(line, x) - r)
                 / torch.linalg.vector_norm(r))


def semicoarsen_x(SS):
    """Galerkin (R A P) coarse stencil with P = linear interpolation in x
    only and R = P^T; coarse columns sit at even fine columns and the 3x3
    footprint is kept.  Per fine x-diagonal (l = ox -1, c = ox 0,
    r = ox +1), out-of-range fine columns contributing zero:

      diag[J]  = 1/4 c[2J-1] + 1/2 r[2J-1] + 1/2 l[2J] + c[2J]
                 + 1/2 r[2J] + 1/2 l[2J+1] + 1/4 c[2J+1]
      super[J] = 1/2 r[2J] + 1/4 c[2J+1] + 1/2 r[2J+1]
      sub[J]   = 1/2 l[2J] + 1/4 c[2J-1] + 1/2 l[2J-1]"""
    NX = SS.shape[3]
    NXc = (NX + 1) // 2

    def coarsen_diag(l, c, r):
        # pad x with 1 zero left and 2 right: fine j sits at padded j + 1
        lp, cp, rp = (_pad(a, (1, 2)) for a in (l, c, r))

        def sl(a, s):
            return a[:, s:s + 2 * NXc:2]

        l_m1, l_0, l_p1 = sl(lp, 0), sl(lp, 1), sl(lp, 2)
        c_m1, c_0, c_p1 = sl(cp, 0), sl(cp, 1), sl(cp, 2)
        r_m1, r_0, r_p1 = sl(rp, 0), sl(rp, 1), sl(rp, 2)
        d = (0.25 * c_m1 + 0.5 * r_m1 + 0.5 * l_0 + c_0 + 0.5 * r_0
             + 0.5 * l_p1 + 0.25 * c_p1)
        up = 0.5 * r_0 + 0.25 * c_p1 + 0.5 * r_p1
        dn = 0.5 * l_0 + 0.25 * c_m1 + 0.5 * l_m1
        return dn, d, up

    rows = []
    for oy in range(3):
        dn, d, up = coarsen_diag(SS[oy, 0], SS[oy, 1], SS[oy, 2])
        rows.append(torch.stack([dn, d, up]))
    return torch.stack(rows)


def restrict_x(r):
    """R = P^T: r (NY, NX, 2) -> (NY, NXc, 2)."""
    NX = r.shape[1]
    NXc = (NX + 1) // 2
    rp = _pad(r, (1, 2))
    return (rp[:, 1:1 + 2 * NXc:2]
            + 0.5 * (rp[:, 0:2 * NXc:2] + rp[:, 2:2 + 2 * NXc:2]))


def prolong_x(e_c, NX):
    """P: e_c (NY, NXc, 2) -> (NY, NX, 2) by linear interpolation."""
    NY = e_c.shape[0]
    out = torch.zeros((NY, NX, e_c.shape[2]), dtype=e_c.dtype,
                      device=e_c.device)
    out[:, 0::2] = e_c[:, :(NX + 1) // 2]
    ep = _pad(e_c, (0, 1))
    nodd = NX // 2
    out[:, 1::2] = 0.5 * (ep[:, :nodd] + ep[:, 1:nodd + 1])
    return out


class StripLineMG:
    """x-semicoarsened multigrid with exact y-line smoothing, a fixed linear
    preconditioner for lattice (T, p) systems.

    NY, NX : lattice dimensions.
    offs   : DIA stencil offsets (``BlockNewtonKrylov.lattice["offs"]``).
    nu     : damped line-Jacobi sweeps per pre- and post-smooth (default 1).
    omega  : line-Jacobi damping (default 0.8).
    """

    def __init__(self, NY, NX, offs, nu: int = 1, omega: float = 0.8):
        if max(abs(oy) for oy, _ in offs) > 1 \
                or max(abs(ox) for _, ox in offs) > 1:
            raise ValueError(_ORDER1)
        self.NY = int(NY)
        self.offs = list(offs)
        self.nu = int(nu)
        self.omega = float(omega)
        self.nxs = [int(NX)]
        while self.nxs[-1] > 1:
            self.nxs.append((self.nxs[-1] + 1) // 2)

    def setup(self, S, mask2_lat, n):
        """The level hierarchy [(SS, line factors), ...] from the
        equilibrated DIA stencil (once per Jacobian rebuild)."""
        SS = canonical_stencil(S, self.offs, self.NY, self.nxs[0],
                               mask2_lat, n)
        arrs = []
        for NX in self.nxs:
            arrs.append((SS, line_factor(SS)))
            if NX > 1:
                SS = semicoarsen_x(SS)
        return arrs

    def _vcycle(self, arrs, lvl, r):
        SS, fac = arrs[lvl]
        if lvl == len(self.nxs) - 1:
            # one column: the line solve is the exact coarse solve
            return line_solve(fac, r)
        om = self.omega
        z = om * line_solve(fac, r)
        for _ in range(self.nu - 1):
            z = z + om * line_solve(fac, r - stencil_matvec(SS, z))
        rc = restrict_x(r - stencil_matvec(SS, z))
        z = z + prolong_x(self._vcycle(arrs, lvl + 1, rc), self.nxs[lvl])
        for _ in range(self.nu):
            z = z + om * line_solve(fac, r - stencil_matvec(SS, z))
        return z

    def apply(self, arrs, r2n, mask=None):
        """The preconditioner on the stacked lattice-layout vector (2n,) =
        [T (NY*NX); p (NY*NX)].  ``mask`` (2n,) bool: essential rows pass
        through as exact identity (the output is clamped there, since
        restriction and prolongation mix neighbours into masked
        positions)."""
        NY, NX = self.NY, self.nxs[0]
        n = NY * NX
        r = torch.stack([r2n[:n].reshape(NY, NX),
                         r2n[n:].reshape(NY, NX)], dim=-1)
        z = self._vcycle(arrs, 0, r)
        out = torch.cat([z[..., 0].reshape(-1), z[..., 1].reshape(-1)])
        if mask is not None:
            out = torch.where(mask, r2n, out)
        return out
