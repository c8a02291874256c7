"""Semi-Lagrangian ALE remap of per-QP reaction state.

Port of ``cmfem_tpu/motion/remap.py`` (the reference's RemapExtentsALE,
ablation_test_case2_2_2D.cpp:3148-3273): before the mesh moves, each QP
adopts the extents currently stored at the material point that will occupy
its post-move location (x_q + w_q dt), found by point location + nearest-QP
donor.  Runs between ``prepare_advance`` (mesh velocity available) and
``commit_advance`` (mesh not yet moved).

- ``remap_extents_ale`` (the eager driver's) is host numpy, as in the JAX
  package: a batched in-element inverse map handles the bulk (the motion
  per step is much smaller than an element), stragglers fall back to
  ``core.pointlocate.locate_points``.
- ``StructuredStripRemap`` (quad strips) and ``TriStripRemap`` (triangle
  strips) are the scan path's device versions: torch, on the tensors they
  are given.  ``make_scan_remap`` picks one by the mesh's geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pointlocate import locate_points
from ..core.reference_elements import QUAD, TRIANGLE
from ..utils.timing import host_sync


def _host(a):
    if torch.is_tensor(a):
        host_sync()
        return a.detach().cpu().numpy()
    return np.asarray(a)


class StructuredStripRemap:
    """Device semi-Lagrangian extent remap for structured quad strips under
    VERTICAL-ONLY mesh motion (the reference's transfinite strip meshes:
    the recession velocity is vertical and the vector-Laplacian smoothing
    keeps it so), which makes each QP's column index and ref-u weight
    static.  The donor search is one batched ``searchsorted`` over the
    current y lattice of each QP's column, and the bilinear inverse map is
    closed-form (x(u) is independent of v on a vertical-motion trapezoid,
    so u = u_own and v = (y - y_lo(u)) / (y_hi(u) - y_lo(u)))."""

    def __init__(self, mesh, ops):
        from ..solvers.blocksolve import strip_dof_lattice

        if mesh.geom != QUAD:
            raise NotImplementedError(
                "StructuredStripRemap requires a structured quad strip")
        verts0 = np.asarray(mesh.vertices)
        # the vertex lattice by the block solver's tolerance clustering
        # (GMSH emits float jitter in column x coordinates)
        vert_lat = strip_dof_lattice(verts0)
        nyv, nxv = vert_lat.shape
        nv = len(verts0)
        xs = verts0[:, 0][vert_lat].mean(axis=0)   # jitter-averaged columns
        row_of = np.empty(nv, dtype=np.int64)
        col_of = np.empty(nv, dtype=np.int64)
        rr, cc = np.indices(vert_lat.shape)
        row_of[vert_lat.ravel()] = rr.ravel()
        col_of[vert_lat.ravel()] = cc.ravel()
        conn = np.asarray(mesh.elem_conn)
        er = row_of[conn].min(axis=1)
        ec = col_of[conn].min(axis=1)
        elem_lat = np.full((nyv - 1, nxv - 1), -1, dtype=np.int64)
        elem_lat[er, ec] = np.arange(len(conn))
        if (elem_lat < 0).any():
            raise ValueError("mesh elements do not tile the strip lattice")

        xq0 = _host(ops.gf.xq).reshape(-1, 2)   # the x column is static
        ic = np.clip(np.searchsorted(xs, xq0[:, 0], side="right") - 1,
                     0, nxv - 2)
        sx = (xq0[:, 0] - xs[ic]) / (xs[ic + 1] - xs[ic])
        self.ne, self.nq = tuple(ops.gf.wdetJ.shape)
        self.nyv = nyv
        dev = ops.device
        index = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        self.vert_lat = index(vert_lat)
        self.elem_lat = index(elem_lat)
        self.ic = index(ic)
        self.sx = torch.as_tensor(sx, dtype=ops.dtype, device=dev)
        self.qp_ref = torch.as_tensor(np.asarray(ops.quad.points),
                                      dtype=ops.dtype, device=dev)

    def __call__(self, extent, verts, xq, wq, dt):
        """extent (ne, nq, nr), verts (nv, 2) CURRENT (pre-move), xq
        (ne, nq, 2) current QP coordinates, wq (ne, nq, 2) mesh velocity at
        the QPs, dt a float.  Returns the remapped extents."""
        ne, nq = self.ne, self.nq
        nr = extent.shape[-1]
        # the vertical-only-motion contract: the column index and ref-u
        # weight are static, so any horizontal velocity would pick donors
        # from the wrong column
        wx = float(torch.max(torch.abs(wq[..., 0])))
        wy = float(torch.max(torch.abs(wq[..., 1])))
        if wx > 1e-10 * max(wy, 1.0):
            raise ValueError(
                "StructuredStripRemap requires vertical-only mesh "
                f"motion; got max |w_x| = {wx:g}")
        dtype = extent.dtype
        sx = self.sx.to(dtype)
        qp_ref = self.qp_ref.to(dtype)
        ylat = verts[:, 1][self.vert_lat]                 # (nyv, nxv)
        Yl = ylat[:, self.ic]                             # (nyv, M)
        Yr = ylat[:, self.ic + 1]
        yedges = ((1.0 - sx) * Yl + sx * Yr).T.contiguous()  # (M, nyv)
        y_t = (xq[..., 1] + wq[..., 1] * dt).reshape(-1)
        row = torch.searchsorted(yedges, y_t[:, None].contiguous(),
                                 right=True)[:, 0] - 1
        row = torch.clamp(row, 0, self.nyv - 2)
        ylo = torch.gather(yedges, 1, row[:, None])[:, 0]
        yhi = torch.gather(yedges, 1, row[:, None] + 1)[:, 0]
        h = yhi - ylo
        vref = (y_t - ylo) / torch.maximum(
            h, torch.tensor(torch.finfo(h.dtype).tiny, dtype=h.dtype,
                            device=h.device))
        donor = self.elem_lat[row, self.ic]
        d2 = (sx[:, None] - qp_ref[None, :, 0]) ** 2 \
            + (vref[:, None] - qp_ref[None, :, 1]) ** 2
        qnear = torch.argmin(d2, dim=1)
        Xf = extent.reshape(-1, nr)
        Xn = torch.clamp(Xf[donor * nq + qnear], 0.0, 1.0)
        return Xn.reshape(ne, nq, nr)


class TriStripRemap:
    """Device semi-Lagrangian extent remap for TRIANGLE strips under small
    per-step mesh motion.

    Contract: the per-step displacement |w dt| (clamped by
    ``max_step_recession``) stays below every QP's distance to its element
    boundary, so the donor point x_q + w_q dt is always inside the QP's own
    element (the host path's own-element fast path hits 100%);
    ``margin()`` is the initial mesh's safe bound.  The affine triangle
    inverse map is closed-form, so the remap is a batched 2x2 solve and a
    nearest-reference-QP gather."""

    def __init__(self, mesh, ops):
        if mesh.geom != TRIANGLE:
            raise NotImplementedError("TriStripRemap requires triangles")
        self.ne, self.nq = tuple(ops.gf.wdetJ.shape)
        self.conn = torch.as_tensor(np.asarray(mesh.elem_conn,
                                               dtype=np.int64),
                                    device=ops.device)
        self.qp_ref = torch.as_tensor(np.asarray(ops.quad.points),
                                      dtype=ops.dtype, device=ops.device)
        # initial-mesh safe bound: min over QPs of the barycentric margin
        # scaled to physical length (conservative: the min edge length)
        verts0 = np.asarray(mesh.vertices)
        qp = np.asarray(ops.quad.points)
        bary_margin = float(np.min([qp[:, 0].min(), qp[:, 1].min(),
                                    (1.0 - qp.sum(axis=1)).min()]))
        ec = verts0[np.asarray(mesh.elem_conn)]
        e01 = np.linalg.norm(ec[:, 1] - ec[:, 0], axis=1)
        e02 = np.linalg.norm(ec[:, 2] - ec[:, 0], axis=1)
        e12 = np.linalg.norm(ec[:, 2] - ec[:, 1], axis=1)
        hmin = float(np.min(np.stack([e01, e02, e12])))
        self._margin = bary_margin * hmin

    def margin(self):
        """Initial-mesh lower bound on the per-step displacement that keeps
        every donor inside its own element."""
        return self._margin

    def __call__(self, extent, verts, xq, wq, dt):
        """extent (ne, nq, nr), verts CURRENT (pre-move), xq (ne, nq, 2)
        current QP coordinates, wq the mesh velocity at the QPs."""
        qp_ref = self.qp_ref.to(extent.dtype)
        target = xq + wq * dt                       # (ne, nq, 2)
        ec = verts[self.conn]                       # (ne, 3, 2)
        v0 = ec[:, None, 0]
        a00 = (ec[:, 1, 0] - ec[:, 0, 0])[:, None]
        a10 = (ec[:, 1, 1] - ec[:, 0, 1])[:, None]
        a01 = (ec[:, 2, 0] - ec[:, 0, 0])[:, None]
        a11 = (ec[:, 2, 1] - ec[:, 0, 1])[:, None]
        rhs = target - v0
        det = a00 * a11 - a01 * a10
        tiny = torch.finfo(det.dtype).tiny
        inv = torch.where(torch.abs(det) > tiny, 1.0 / det,
                          torch.zeros_like(det))
        r0 = (a11 * rhs[..., 0] - a01 * rhs[..., 1]) * inv
        r1 = (-a10 * rhs[..., 0] + a00 * rhs[..., 1]) * inv
        d2 = (r0[..., None] - qp_ref[None, None, :, 0]) ** 2 \
            + (r1[..., None] - qp_ref[None, None, :, 1]) ** 2
        qnear = torch.argmin(d2, dim=2)             # (ne, nq)
        idx = qnear[..., None].expand(-1, -1, extent.shape[-1])
        return torch.clamp(torch.gather(extent, 1, idx), 0.0, 1.0)


def make_scan_remap(mesh, ops):
    """The scan path's device remap for this mesh: the structured quad-strip
    lattice remap, or the own-element triangle-strip remap."""
    if mesh.geom == QUAD:
        return StructuredStripRemap(mesh, ops)
    if mesh.geom == TRIANGLE:
        return TriStripRemap(mesh, ops)
    raise NotImplementedError(
        f"no jittable scan remap for geometry {mesh.geom}")


def _invert_in_own_element(geom, ecoords, pts):
    """Batched inverse map of pts (m, 2) in their own elements
    ecoords (m, nc, 2). Returns (ref (m, 2), inside (m,))."""
    m = len(pts)
    if geom == TRIANGLE:
        v0 = ecoords[:, 0]
        A = np.stack([ecoords[:, 1] - v0, ecoords[:, 2] - v0], axis=2)
        rhs = pts - v0
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        inv_det = np.where(np.abs(det) > 1e-300, 1.0 / det, 0.0)
        r0 = (A[:, 1, 1] * rhs[:, 0] - A[:, 0, 1] * rhs[:, 1]) * inv_det
        r1 = (-A[:, 1, 0] * rhs[:, 0] + A[:, 0, 0] * rhs[:, 1]) * inv_det
        ref = np.stack([r0, r1], axis=1)
        inside = (r0 >= -1e-9) & (r1 >= -1e-9) & (r0 + r1 <= 1 + 1e-9)
        return ref, inside
    if geom == QUAD:
        r = np.full((m, 2), 0.5)
        c = ecoords
        for _ in range(15):
            u = r[:, 0]
            v = r[:, 1]
            N = np.stack([(1 - u) * (1 - v), u * (1 - v), u * v,
                          (1 - u) * v], 1)
            dNu = np.stack([-(1 - v), (1 - v), v, -v], 1)
            dNv = np.stack([-(1 - u), -u, u, (1 - u)], 1)
            xr = np.einsum("mn,mnd->md", N, c)
            Ju = np.einsum("mn,mnd->md", dNu, c)
            Jv = np.einsum("mn,mnd->md", dNv, c)
            det = Ju[:, 0] * Jv[:, 1] - Ju[:, 1] * Jv[:, 0]
            inv_det = np.where(np.abs(det) > 1e-300, 1.0 / det, 0.0)
            rhs = pts - xr
            du = (Jv[:, 1] * rhs[:, 0] - Jv[:, 0] * rhs[:, 1]) * inv_det
            dv = (-Ju[:, 1] * rhs[:, 0] + Ju[:, 0] * rhs[:, 1]) * inv_det
            r[:, 0] += du
            r[:, 1] += dv
        inside = ((r >= -1e-9) & (r <= 1 + 1e-9)).all(axis=1)
        return np.clip(r, 0, 1), inside
    raise NotImplementedError(geom)


def remap_extents_ale(mesh, ops, extent, mesh_velocity_qp, dt, vertices):
    """The remapped extents (ne, nq, nr), a numpy array.

    extent: committed per-QP extents on the CURRENT (pre-move) mesh;
    mesh_velocity_qp: (ne, nq, dim); vertices: current vertex coordinates
    (numpy arrays or tensors on any device)."""
    if dt <= 0:
        return extent
    extent = _host(extent)
    ne, nq, nr = extent.shape
    vertices = _host(vertices)
    xq = _host(ops.geometric_factors(vertices).xq).reshape(-1, mesh.dim)
    w = _host(mesh_velocity_qp).reshape(-1, mesh.dim)
    targets = xq + w * dt
    own_elem = np.repeat(np.arange(ne), nq)

    coords = vertices[mesh.elem_conn]  # (ne, nc, 2)
    ref, inside = _invert_in_own_element(mesh.geom, coords[own_elem], targets)
    found_elem = np.where(inside, own_elem, -1)

    missing = np.nonzero(~inside)[0]
    if len(missing):
        e2, r2 = locate_points(mesh, targets[missing], vertices=vertices)
        found_elem[missing] = e2
        ref[missing] = r2

    # nearest tabulated reference QP in the donor element
    qp_ref = np.asarray(ops.quad.points)  # (nq, 2)
    d2 = ((ref[:, None, :] - qp_ref[None, :, :]) ** 2).sum(axis=2)
    nearest_q = np.argmin(d2, axis=1)

    new_flat = extent.reshape(-1, nr).copy()
    ok = found_elem >= 0
    src = found_elem[ok] * nq + nearest_q[ok]
    new_flat[ok] = np.clip(extent.reshape(-1, nr)[src], 0.0, 1.0)
    return new_flat.reshape(ne, nq, nr)
