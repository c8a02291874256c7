"""Geometric factors: per-element, per-QP Jacobians J, detJ, J^{-1}.

Port of ``cmfem_tpu/core/geometry.py``: ``compute_geometric_factors`` runs
on torch tensors (any device), ``compute_geometric_factors_host`` is the
numpy copy used at setup.  Face factors wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GeometricFactors:
    """detJ (ne, nq), invJ (ne, nq, dim, dim), wdetJ (ne, nq),
    xq (ne, nq, dim) physical quadrature points."""

    detJ: torch.Tensor
    invJ: torch.Tensor
    wdetJ: torch.Tensor
    xq: torch.Tensor

    def to(self, device=None, dtype=None) -> "GeometricFactors":
        """The same factors as tensors on ``device`` in ``dtype``."""
        cv = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
        return GeometricFactors(cv(self.detJ), cv(self.invJ), cv(self.wdetJ),
                                cv(self.xq))


def _inv_det(J, xp=torch):
    """Batched inverse + determinant for 1x1/2x2/3x3 matrices.
    ``xp`` selects the array module (torch, or np for the host setup)."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, dd = J[..., 1, 0], J[..., 1, 1]
        det = a * dd - b * c
        inv = xp.stack(
            [xp.stack([dd, -b], -1), xp.stack([-c, a], -1)], -2
        ) / det[..., None, None]
        return det, inv
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv = xp.stack(
            [
                xp.stack([c00, c10, c20], -1),
                xp.stack([c01, c11, c21], -1),
                xp.stack([c02, c12, c22], -1),
            ],
            -2,
        ) / det[..., None, None]
        return det, inv
    raise ValueError(d)


def compute_geometric_factors(coords_e, Bgeo, Ggeo, weights) -> GeometricFactors:
    """Geometric factors from element geometry-node coordinates (torch).

    coords_e : (ne, ng, dim) geometry node coords
    Bgeo     : (nq, ng) geometry shape values at quadrature points
    Ggeo     : (nq, ng, dim) geometry shape gradients (reference)
    weights  : (nq,) quadrature weights
    All are moved to ``coords_e``'s device and dtype.
    """
    coords_e = torch.as_tensor(coords_e)
    cv = lambda a: torch.as_tensor(a).to(device=coords_e.device,
                                         dtype=coords_e.dtype)
    Bgeo, Ggeo, weights = cv(Bgeo), cv(Ggeo), cv(weights)
    # J[e,q,d,r] = sum_n coords[e,n,d] * Ggeo[q,n,r]
    J = torch.einsum("end,qnr->eqdr", coords_e, Ggeo)
    det, inv = _inv_det(J)
    xq = torch.einsum("qn,end->eqd", Bgeo, coords_e)
    return GeometricFactors(det, inv, weights[None, :] * det, xq)


def compute_geometric_factors_host(coords_e, Bgeo, Ggeo, weights):
    """Setup-time geometric factors computed in numpy (float64)."""
    coords_e = np.asarray(coords_e)
    Bgeo = np.asarray(Bgeo)
    Ggeo = np.asarray(Ggeo)
    weights = np.asarray(weights)
    J = np.einsum("end,qnr->eqdr", coords_e, Ggeo)
    det, inv = _inv_det(J, xp=np)
    xq = np.einsum("qn,end->eqd", Bgeo, coords_e)
    return GeometricFactors(det, inv, weights[None, :] * det, xq)
