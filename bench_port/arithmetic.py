"""Operations and bytes of one operator apply, from the problem's sizes
(frozen).

The count is ``chip_smoke.py``'s (``sumfact_flops``, ``nbytes``), which
counts as ``bench.py`` does, rewritten to take the sizes of the problem and
not an operator object's fields, so that a later kernel cannot change what
an apply is worth:

- n elements per axis of order p with q1 quadrature points per axis (a
  lattice of N = n p + 1 DOFs and K = n q1 points per axis);
- the pointwise D stage: 2 FLOPs per point and stored component (ncomp
  compressed planes, 10 for a scalar CDR form in 3D);
- each 1D contraction 2 (p + 1) FLOPs per output, forward and transposed:
  2 K N^2 outputs along x, 4 K^2 N along y and 6 K^3 along z;
- bytes: the input vector read once, the output written once, and D read
  once (``z_periodic``: one element layer of planes along z, as the form
  on a uniform lattice stores it).
"""


def sumfact_apply_flops(n, p, q1, ncomp=10):
    """FLOPs of one sum-factorized apply on an n^3 lattice of order p."""
    N, K = n * p + 1, n * q1
    contr = 2 * (p + 1) * (2 * K * N * N + 4 * K * K * N + 6 * K ** 3)
    return 2 * ncomp * K ** 3 + 2 * contr


def sumfact_apply_bytes(n, p, q1, ncomp=10, itemsize=4, z_periodic=True):
    """Bytes one apply must move: u in, y out, D once."""
    N, K = n * p + 1, n * q1
    d_planes = ncomp * (q1 if z_periodic else K) * K * K
    return itemsize * (2 * N ** 3 + d_planes)
