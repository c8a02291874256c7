"""Point sampling on a receding mesh by tracked candidates, on the device.

Port of ``cmfem_tpu/core/tracksample.py``.  The case-2.2 scan path samples
its probes, its front line and its mass-equation probes every step; the
physical points are fixed and the recession moves vertices vertically by a
bounded amount, so the elements that can ever contain a point form a small
static candidate list: (point, element) pairs from the initial geometry
with a vertical slack band.  Each step redoes only a batched barycentric
test against the CURRENT vertices, on the device, with no read-back.
Semantics (NaN where not found, lowest-element-id donor) match
``core.pointlocate``'s host versions.

Order-1 triangle meshes only (the JAX package's scope).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh
from .reference_elements import TRIANGLE

BIG = np.iinfo(np.int32).max


class TrackedSampler:
    """Precomputed candidate-pair point locator for fixed physical points
    on a moving-vertex triangle mesh.

    ``y_slack`` widens each element's candidate bbox vertically; it must
    cover the TOTAL mesh motion over the run (derive it from a recession
    bound): a band smaller than the realized motion turns the samples NaN
    once the surface recedes past it."""

    def __init__(self, mesh: Mesh, points, y_slack: float = 0.01,
                 tol: float = 1e-9, *, device, dtype=torch.float64):
        if mesh.geom != TRIANGLE:
            raise NotImplementedError(
                "TrackedSampler supports order-1 triangle meshes")
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        verts0 = np.asarray(mesh.vertices)
        conn = np.asarray(mesh.elem_conn)
        coords = verts0[conn]                      # (ne, 3, 2)
        lo = coords.min(axis=1)
        hi = coords.max(axis=1)
        lo[:, 1] -= y_slack
        hi[:, 1] += y_slack
        lo -= tol
        hi += tol
        inside = ((pts[:, None, :] >= lo[None]) &
                  (pts[:, None, :] <= hi[None])).all(axis=2)
        ip, ie = np.nonzero(inside)                # sorted by (point, elem)
        index = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                          device=device)
        self.npts = len(pts)
        self.npairs = len(ip)
        self.ip = index(ip)
        self.ie = index(ie)
        self.ie32 = self.ie.to(torch.int32)
        self.pair_conn = index(conn[ie])           # (npairs, 3)
        self.pts = torch.as_tensor(pts, dtype=dtype, device=device)
        self.conn = index(conn)
        self.tol = float(tol)

    # -- location -------------------------------------------------------

    def locate(self, verts, pts=None):
        """(eid (npts,) int32 [-1 when not found], ref (npts, 2),
        found (npts,) bool) against the CURRENT vertices.  The donor is the
        lowest containing element id, the host ``locate_points`` order.

        ``pts`` optionally overrides the query positions (same count and
        order as construction), e.g. a wall probe whose y tracks the
        receding surface; they must stay within the construction points'
        slack band for the candidate list to remain valid."""
        eps = 1e-9
        qpts = self.pts if pts is None else pts
        v = verts[self.pair_conn]                  # (npairs, 3, 2)
        v0 = v[:, 0]
        a = v[:, 1] - v0
        b = v[:, 2] - v0
        det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        rhs = qpts[self.ip] - v0
        ok = torch.abs(det) > 1e-30
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0),
                          torch.zeros_like(det))
        r0 = (b[:, 1] * rhs[:, 0] - b[:, 0] * rhs[:, 1]) * inv
        r1 = (-a[:, 1] * rhs[:, 0] + a[:, 0] * rhs[:, 1]) * inv
        ins = ok & (r0 >= -eps) & (r1 >= -eps) & (r0 + r1 <= 1.0 + eps)
        key = torch.where(ins, self.ie32, BIG)
        eid = torch.full((self.npts,), BIG, dtype=torch.int32,
                         device=verts.device)
        eid.scatter_reduce_(0, self.ip, key, "amin", include_self=True)
        found = eid < BIG
        # exactly one pair per point satisfies (ins & ie == eid[ip])
        chosen = ins & (self.ie32 == eid[self.ip])
        ref = torch.zeros((self.npts, 2), dtype=verts.dtype,
                          device=verts.device).index_add_(
            0, self.ip, torch.where(chosen[:, None],
                                    torch.stack([r0, r1], dim=1), 0.0))
        return torch.where(found, eid, -1), ref, found

    # -- sampling (compose with one locate per step) ----------------------

    def sample_h1(self, loc, u):
        """P1 nodal interpolation of ``u`` (n,) at the located points; NaN
        where not found."""
        eid, ref, found = loc
        un = u[self.conn[torch.clamp(eid, min=0)]]   # (npts, 3)
        val = (un[:, 0] * (1.0 - ref[:, 0] - ref[:, 1])
               + un[:, 1] * ref[:, 0] + un[:, 2] * ref[:, 1])
        return torch.where(found, val, float("nan"))

    def sample_grad(self, loc, u, verts):
        """Physical gradient of a P1 field at the located points (constant
        per triangle): (npts, 2), NaN rows where not found."""
        eid, ref, found = loc
        tri = self.conn[torch.clamp(eid, min=0)]
        v = verts[tri]                             # (npts, 3, 2)
        a = v[:, 1] - v[:, 0]
        b = v[:, 2] - v[:, 0]
        det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        ok = torch.abs(det) > 1e-30
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0),
                          torch.zeros_like(det))
        un = u[tri]
        du1 = un[:, 1] - un[:, 0]
        du2 = un[:, 2] - un[:, 0]
        # grad = A^-T [du1, du2]; A = [a b] columns
        gx = (b[:, 1] * du1 - a[:, 1] * du2) * inv
        gy = (-b[:, 0] * du1 + a[:, 0] * du2) * inv
        g = torch.stack([gx, gy], dim=1)
        return torch.where(found[:, None], g, float("nan"))

    def sample_l2(self, loc, elem_vals):
        """Per-element (L2(0)) field at the located points; NaN where not
        found."""
        eid, _, found = loc
        return torch.where(found, elem_vals[torch.clamp(eid, min=0)],
                           float("nan"))


def line_points(x, y_top, y_bottom, ns: int = 250):
    """The ``front_depth`` sampling line: ns+1 points from just below
    y_top down to just above y_bottom at fixed x (host front_depth's
    grid, core/pointlocate.py)."""
    eps = 1e-9
    y0 = y_top - eps
    y1 = y_bottom + eps
    ys = y0 - np.arange(ns + 1) * (y0 - y1) / ns
    return np.stack([np.full(ns + 1, x), ys], axis=1)


def front_depth_from_samples(vals, ys, y_top, threshold):
    """Crossing detection of host ``front_depth`` on the device: depth
    below ``y_top`` of the first finite-pair threshold crossing (either
    direction) along the sampled line, else 0 (a 0-d tensor).

    ``vals``/``ys`` are the line samples ordered top->bottom; ``y_top`` is
    the CURRENT surface height (samples above it are NaN, skipped, so a
    receded-away prefix never produces a crossing)."""
    vp = vals[:-1]
    vc = vals[1:]
    fin = torch.isfinite(vp) & torch.isfinite(vc)
    crossing = fin & (((vp > threshold) & (vc <= threshold))
                      | ((vp < threshold) & (vc >= threshold)))
    # the FIRST True: argmax over an integer cast (0 if none)
    k = torch.argmax(crossing.to(torch.int32))
    any_ = torch.any(crossing)
    vpk = vp[k]
    vck = vc[k]
    denom = vpk - vck
    zero = torch.zeros_like(denom)
    frac = torch.where(torch.abs(denom) < 1e-14, zero, torch.minimum(
        torch.maximum((vpk - threshold) / denom, zero), zero + 1.0))
    y_cross = ys[k] - frac * (ys[k] - ys[k + 1])
    depth = torch.maximum(zero, y_top - y_cross)
    return torch.where(any_, depth, zero)
