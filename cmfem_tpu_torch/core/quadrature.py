"""Quadrature rules per geometry (numpy copy of ``cmfem_tpu/core/quadrature.py``).

Tabulated once (numpy, f64); consumed on device as static arrays.  Matches
the accuracy conventions of the reference (MFEM ``IntRules.Get(geom, order)``
exactness in total degree).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .reference_elements import (
    SEGMENT,
    TRIANGLE,
    QUAD,
    TETRAHEDRON,
    HEXAHEDRON,
)


@dataclass(frozen=True)
class QuadratureRule:
    geom: str
    order: int  # polynomial exactness (total degree)
    points: np.ndarray  # (nqp, dim)
    weights: np.ndarray  # (nqp,)

    @property
    def nqp(self) -> int:
        return len(self.weights)


def _gauss_1d(n: int):
    """n-point Gauss-Legendre on [0,1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def gauss_rule(geom: str, order: int) -> QuadratureRule:
    """Quadrature exact for total-degree `order` polynomials on `geom`."""
    order = max(0, int(order))
    n1 = order // 2 + 1  # 1D Gauss points for exactness `order`
    if geom == SEGMENT:
        x, w = _gauss_1d(n1)
        return QuadratureRule(geom, order, x[:, None], w)
    if geom == QUAD:
        x, w = _gauss_1d(n1)
        X, Y = np.meshgrid(x, x, indexing="xy")
        W = np.outer(w, w)
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        return QuadratureRule(geom, order, pts, W.ravel())
    if geom == HEXAHEDRON:
        x, w = _gauss_1d(n1)
        pts = np.array([(a, b, c) for c in x for b in x for a in x])
        wts = np.array([wa * wb * wc for wc in w for wb in w for wa in w])
        return QuadratureRule(geom, order, pts, wts)
    if geom == TRIANGLE:
        return _triangle_rule(order)
    if geom == TETRAHEDRON:
        return _tet_rule(order)
    raise ValueError(f"Unsupported geometry: {geom}")


def _conical_product_tri(order: int) -> QuadratureRule:
    """Conical-product (Duffy) rule on the unit triangle, exact to `order`."""
    n = order // 2 + 1
    # Gauss-Jacobi weights for the radial direction (weight (1-x))
    xj, wj = _gauss_jacobi_general(n, 1.0)
    xg, wg = _gauss_1d(n)
    pts = []
    wts = []
    for i in range(n):
        for j in range(n):
            x = xj[i]
            y = xg[j] * (1.0 - xj[i])
            pts.append((x, y))
            wts.append(wj[i] * wg[j])
    return QuadratureRule(TRIANGLE, order, np.array(pts), np.array(wts))


@lru_cache(maxsize=None)
def _triangle_rule(order: int) -> QuadratureRule:
    return _conical_product_tri(order)


@lru_cache(maxsize=None)
def _tet_rule(order: int) -> QuadratureRule:
    """Conical product rule on the unit tet (Duffy), exact to `order`."""
    n = order // 2 + 1
    x2, w2 = _gauss_jacobi_general(n, 2.0)
    x1, w1 = _gauss_jacobi_general(n, 1.0)
    xg, wg = _gauss_1d(n)
    pts, wts = [], []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                x = x2[i]
                y = x1[j] * (1 - x)
                z = xg[k] * (1 - x - y)
                pts.append((x, y, z))
                wts.append(w2[i] * w1[j] * wg[k])
    return QuadratureRule(TETRAHEDRON, order, np.array(pts), np.array(wts))


def _gauss_jacobi_general(n: int, alpha: float):
    """Gauss-Jacobi on [0,1] with weight (1-x)^alpha, normalized so the
    rule integrates f(x)(1-x)^alpha exactly."""
    beta = 0.0
    ab = alpha + beta
    a = np.zeros(n)
    b = np.zeros(n)
    for i in range(n):
        ki = float(i)
        denom = (2 * ki + ab) * (2 * ki + ab + 2)
        if denom != 0:
            a[i] = (beta**2 - alpha**2) / denom
        else:
            a[i] = (beta - alpha) / (ab + 2)
    for i in range(1, n):
        ki = float(i)
        num = 4 * ki * (ki + alpha) * (ki + beta) * (ki + ab)
        den = (2 * ki + ab) ** 2 * (2 * ki + ab + 1) * (2 * ki + ab - 1)
        b[i] = num / den
    J = np.diag(a) + np.diag(np.sqrt(b[1:]), 1) + np.diag(np.sqrt(b[1:]), -1)
    nodes, vecs = np.linalg.eigh(J)
    from math import gamma as _gamma

    mu0 = 2.0 ** (ab + 1) * _gamma(alpha + 1) * _gamma(beta + 1) / _gamma(ab + 2)
    weights = mu0 * vecs[0, :] ** 2
    x01 = 0.5 * (nodes + 1.0)
    w01 = weights * 0.5 ** (ab + 1)
    return x01, w01
