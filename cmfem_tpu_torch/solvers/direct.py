"""Dense direct solve (LU) for small systems.

Port of ``cmfem_tpu/solvers/direct.py`` (which stands in for the reference's
MUMPS LU on the smoke-scale Newton systems).  The global matrix comes from
``BilinearForm.dense_matrix``; LU runs on the tensor's device through
``torch.linalg.lu_factor``/``lu_solve``: library calls here as they are in
the JAX package (``jax.scipy.linalg``)."""

from __future__ import annotations

import torch


def dense_factor(A):
    """(LU, pivots) of A with partial pivoting."""
    return torch.linalg.lu_factor(A)


def dense_apply_factor(fac, b):
    """x = A^{-1} b from ``dense_factor(A)``; b (n,) or (n, k)."""
    LU, piv = fac
    if b.dim() == 1:
        return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]
    return torch.linalg.lu_solve(LU, piv, b)


def dense_solve(A, b):
    """x = A^{-1} b via LU with partial pivoting."""
    return dense_apply_factor(dense_factor(A), b)
