"""Analytic ALE maps for the SCL-preserving backward-Euler verification.

Port of ``cmfem_tpu/motion/ale.py`` (the reference ``AleMap``,
diffusion_mms_ale.cpp:213-443): the three maps of Ivancic et al. Example
7.3 with gradient G, cofactor C = cof(G), J = det G, and the closed-form
time-integrated grid flux phi_hat.

Every function is vectorized over reference points xhat (..., 2) and takes
its array module from xhat: a tensor gives tensors on its device (the
quadrature points of the per-step assembly), a numpy array gives numpy (the
node positions that ``FESpace.interpolate`` and the VTU fields use).  ``t``
is a Python float or a 0-d tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi

IDENTITY = "identity"
ACCURACY_A = "accuracy_a"
ACCURACY_B = "accuracy_b"


def parse_kind(s: str) -> str:
    s = str(s).lower()
    if s in ("identity", "id"):
        return IDENTITY
    if s in ("accuracy_a", "map_a"):
        return ACCURACY_A
    if s in ("accuracy_b", "map_b"):
        return ACCURACY_B
    raise ValueError(f"ale_map must be: identity | accuracy_a | accuracy_b. "
                     f"Got: {s}")


def _xp(x):
    """The array module of x: torch for a tensor, numpy otherwise."""
    return torch if torch.is_tensor(x) else np


def _sin(t):
    return torch.sin(t) if torch.is_tensor(t) else math.sin(t)


def _amp_a(t):
    return 0.5 * _sin(PI * t)


def _shape_a(z):
    h = ((-z + 1.5) * z - 0.5) * z
    return _xp(z).sin(PI * h)


def _shape_a_d1(z):
    h = ((-z + 1.5) * z - 0.5) * z
    hp = (-3.0 * z + 3.0) * z - 0.5
    return PI * _xp(z).cos(PI * h) * hp


def _amp_b(t):
    return _sin(PI * t)


def _stack2(a, b, axis):
    return _xp(a).stack([a, b], axis)


class AleMap:
    def __init__(self, kind: str):
        self.kind = parse_kind(kind)

    def map_point(self, xhat, t):
        xh = xhat[..., 0]
        yh = xhat[..., 1]
        if self.kind == IDENTITY:
            return xhat
        if self.kind == ACCURACY_A:
            a = _amp_a(t)
            return _stack2(xh + a * _shape_a(xh), yh + a * _shape_a(yh), -1)
        a = _amp_b(t)
        q = xh * (1 - xh) * yh * (1 - yh)
        return _stack2(xh + a * q, yh + a * q, -1)

    def gradient(self, xhat, t):
        """G = dA/dxhat, (..., 2, 2)."""
        xp = _xp(xhat)
        xh = xhat[..., 0]
        yh = xhat[..., 1]
        one = xp.ones_like(xh)
        zero = xp.zeros_like(xh)
        mat = lambda a, b, c, d: _stack2(_stack2(a, b, -1),
                                         _stack2(c, d, -1), -2)
        if self.kind == IDENTITY:
            return mat(one, zero, zero, one)
        if self.kind == ACCURACY_A:
            a = _amp_a(t)
            return mat(1 + a * _shape_a_d1(xh), zero,
                       zero, 1 + a * _shape_a_d1(yh))
        a = _amp_b(t)
        ax = xh * (1 - xh)
        ay = yh * (1 - yh)
        dax = 1 - 2 * xh
        day = 1 - 2 * yh
        return mat(1 + a * dax * ay, a * ax * day,
                   a * dax * ay, 1 + a * ax * day)

    def cofactor(self, xhat, t):
        """C = cof(G): in 2D cof([[a,b],[c,d]]) = [[d,-b],[-c,a]]."""
        G = self.gradient(xhat, t)
        return _stack2(_stack2(G[..., 1, 1], -G[..., 0, 1], -1),
                       _stack2(-G[..., 1, 0], G[..., 0, 0], -1), -2)

    def jacobian_det(self, xhat, t):
        G = self.gradient(xhat, t)
        return (G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0])

    def integrated_grid_flux(self, xhat, t0, t1):
        """phi_hat = int_{t0}^{t1} cof(G) w dt (closed form) and its
        reference divergence (IntegratedMappedGridFlux :338-407)."""
        xh = xhat[..., 0]
        yh = xhat[..., 1]
        if self.kind == IDENTITY:
            z = _xp(xhat).zeros_like(xh)
            return _stack2(z, z, -1), z
        if self.kind == ACCURACY_A:
            a0 = _amp_a(t0)
            a1 = _amp_a(t1)
            i1 = a1 - a0
            i2 = 0.5 * (a1 * a1 - a0 * a0)
            gx = _shape_a(xh)
            gxp = _shape_a_d1(xh)
            gy = _shape_a(yh)
            gyp = _shape_a_d1(yh)
            phi = _stack2(gx * (i1 + i2 * gyp), gy * (i1 + i2 * gxp), -1)
            div = i1 * (gxp + gyp) + 2.0 * i2 * gxp * gyp
            return phi, div
        a0 = _amp_b(t0)
        a1 = _amp_b(t1)
        i1 = a1 - a0
        ax = xh * (1 - xh)
        ay = yh * (1 - yh)
        dax = 1 - 2 * xh
        day = 1 - 2 * yh
        q = ax * ay
        phi = _stack2(i1 * q, i1 * q, -1)
        div = i1 * (dax * ay + ax * day)
        return phi, div
