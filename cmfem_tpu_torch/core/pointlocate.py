"""Point location + field sampling (the ParMesh::FindPoints equivalent).

Numpy copy of ``cmfem_tpu/core/pointlocate.py``.  Used by ``GeometricMG``
for its transfer stencils (``h1_sampling_stencil``) and by the ablation
drivers for temperature probes, front-depth line sampling, and the ALE
semi-Lagrangian remap.  ``last_locator`` names the candidate stage the
latest ``locate_points`` call took ("native" or "numpy").
Array algorithm: bbox candidate filter + per-element inverse map (affine for
tris, Newton for bilinear quads).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh
from .reference_elements import HEXAHEDRON, QUAD, TETRAHEDRON, TRIANGLE


# the candidate stage of the latest locate_points call
last_locator = None


def locate_points(mesh: Mesh, points: np.ndarray, vertices=None, tol=1e-9):
    """Find containing elements and reference coords for query points.

    points (npts, dim) -> (elem_ids (npts,) int64 [-1 if not found],
    ref_coords (npts, dim)).  All (point, candidate-element) pairs from
    the bbox filter are inverted in one batched numpy sweep."""
    global last_locator
    verts = np.asarray(mesh.vertices if vertices is None else vertices)
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    conn = mesh.elem_conn
    coords = verts[conn]  # (ne, nc, dim)
    lo = coords.min(axis=1) - tol
    hi = coords.max(axis=1) + tol

    npts = len(pts)
    elem_ids = np.full(npts, -1, dtype=np.int64)
    refs = np.zeros((npts, mesh.dim))
    # candidate pairs: (point, element) where the point is in the bbox.
    # For large (npts x ne) workloads (the ALE remap queries every QP of a
    # moving mesh each step) the dense numpy sweep is replaced by the
    # native bucket-grid locator (native/cmfem_native.cpp) — O(npts)
    # candidates instead of an O(npts * ne) boolean matrix.
    ip = ie = None
    if npts * len(conn) > 1 << 20:
        locator = _cached_native_locator(mesh, verts, conn, tol)
        if locator is not None:
            ip, ie = locator.query(pts)
            # match the numpy sweep's deterministic (point, element) order
            # so interface points resolve to the same donor element
            order = np.lexsort((ie, ip))
            ip, ie = ip[order], ie[order]
    last_locator = "numpy" if ip is None else "native"
    if ip is None:
        inside_box = ((pts[:, None, :] >= lo[None]) &
                      (pts[:, None, :] <= hi[None])).all(axis=2)
        ip, ie = np.nonzero(inside_box)
    if len(ip) == 0:
        return elem_ids, refs
    ok, r = _invert_map_batched(mesh.geom, coords[ie], pts[ip], tol)
    # first containing element per point: candidates arrive sorted by
    # (point, element), so the first occurrence of each point id among the
    # hits is the deterministic donor (vectorized — no Python loop)
    hit = np.nonzero(ok)[0]
    if len(hit):
        _, first_idx = np.unique(ip[hit], return_index=True)
        k = hit[first_idx]
        elem_ids[ip[k]] = ie[k]
        refs[ip[k]] = r[k]
    return elem_ids, refs


# one-entry locator cache: repeated fixed-mesh probe sampling (scan
# drivers, per-step probes) reuses the O(ne) bucket grid; any change in
# mesh identity, vertex contents, or tol invalidates it.
_locator_cache: dict = {}


def _cached_native_locator(mesh, verts, conn, tol):
    import hashlib

    from ..native import NativeLocator

    # digest covers vertices AND connectivity: id(mesh) can be recycled
    # by a different mesh object after garbage collection, and identical
    # vertex bytes with renumbered elements would otherwise hit stale
    # element ids
    h = hashlib.blake2b(np.ascontiguousarray(verts).tobytes(),
                        digest_size=16)
    h.update(np.ascontiguousarray(conn).tobytes())
    digest = h.digest()
    key = (id(mesh), float(tol))
    hit = _locator_cache.get(key)
    if hit is not None and hit[0] == digest:
        return hit[1]
    locator = NativeLocator.build(verts, conn, tol)
    _locator_cache.clear()
    _locator_cache[key] = (digest, locator)
    return locator


def _solve_guarded(A, rhs, dim):
    """Batched solve that tolerates degenerate candidate elements (e.g. a
    collapsed cell during ALE motion): singular systems get an identity
    matrix and are reported so the caller can mark them outside, instead
    of np.linalg.solve raising LinAlgError for the whole query batch."""
    bad = ~np.isfinite(A).all(axis=(1, 2)) \
        | (np.abs(np.linalg.det(A)) < 1e-250)
    if bad.any():
        A = A.copy()
        A[bad] = np.eye(dim)
    r = np.linalg.solve(A, rhs[..., None])[..., 0]
    r[bad] = -1.0   # fails every inside test
    return r, bad


def _invert_map_batched(geom, ecoords, x, tol):
    """Batched inverse maps: ecoords (m, nc, dim), x (m, dim) ->
    (inside (m,) bool, ref (m, dim)).  ``tol`` widens the reference-
    coordinate acceptance band (matching the bbox prefilter pad)."""
    m = len(x)
    rtol = max(float(tol), 1e-9)
    if geom == TRIANGLE:
        v = ecoords
        A = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
        r, bad = _solve_guarded(A, x - v[:, 0], 2)
        inside = (~bad) & (r >= -rtol).all(axis=1) \
            & (r.sum(axis=1) <= 1 + rtol)
        return inside, r
    if geom == TETRAHEDRON:
        v = ecoords
        A = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 3] - v[:, 0]], axis=2)
        r, bad = _solve_guarded(A, x - v[:, 0], 3)
        inside = (~bad) & (r >= -rtol).all(axis=1) \
            & (r.sum(axis=1) <= 1 + rtol)
        return inside, r
    if geom == QUAD:
        iu = np.array([0, 1, 1, 0])
        iv = np.array([0, 0, 1, 1])
        ii = (iu, iv, None)
    elif geom == HEXAHEDRON:
        iu = np.array([0, 1, 1, 0, 0, 1, 1, 0])
        iv = np.array([0, 0, 1, 1, 0, 0, 1, 1])
        iw = np.array([0, 0, 0, 0, 1, 1, 1, 1])
        ii = (iu, iv, iw)
    else:
        raise NotImplementedError(geom)
    # batched Newton on the multilinear map
    dim = 2 if geom == QUAD else 3
    r = np.full((m, dim), 0.5)
    du = np.array([-1.0, 1.0])
    for _ in range(25):
        n1 = np.stack([1 - r[:, 0], r[:, 0]], axis=1)  # (m, 2)
        n2 = np.stack([1 - r[:, 1], r[:, 1]], axis=1)
        if dim == 3:
            n3 = np.stack([1 - r[:, 2], r[:, 2]], axis=1)
            N = n1[:, ii[0]] * n2[:, ii[1]] * n3[:, ii[2]]
            dN = [du[ii[0]] * n2[:, ii[1]] * n3[:, ii[2]],
                  n1[:, ii[0]] * du[ii[1]] * n3[:, ii[2]],
                  n1[:, ii[0]] * n2[:, ii[1]] * du[ii[2]]]
        else:
            N = n1[:, ii[0]] * n2[:, ii[1]]
            dN = [du[ii[0]] * n2[:, ii[1]], n1[:, ii[0]] * du[ii[1]]]
        xr = np.einsum("mn,mnd->md", N, ecoords)
        J = np.stack([np.einsum("mn,mnd->md", d, ecoords) for d in dN],
                     axis=2)
        # guard near-singular candidates (Newton wandered outside a skewed
        # element): give them an identity J; the inside check rejects them
        bad = np.abs(np.linalg.det(J)) < 1e-250
        if bad.any():
            J[bad] = np.eye(dim)
        dr = np.linalg.solve(J, (x - xr)[..., None])[..., 0]
        dr[bad] = 0.0
        r = r + dr
        if np.abs(dr).max() < 1e-13:
            break
    # accept only bounded ref coords whose forward map reproduces x
    n1 = np.stack([1 - r[:, 0], r[:, 0]], axis=1)
    n2 = np.stack([1 - r[:, 1], r[:, 1]], axis=1)
    if dim == 3:
        n3 = np.stack([1 - r[:, 2], r[:, 2]], axis=1)
        N = n1[:, ii[0]] * n2[:, ii[1]] * n3[:, ii[2]]
    else:
        N = n1[:, ii[0]] * n2[:, ii[1]]
    resid = np.abs(np.einsum("mn,mnd->md", N, ecoords) - x).max(axis=1)
    scale = np.abs(ecoords).max() + 1.0
    inside = ((r >= -rtol).all(axis=1) & (r <= 1 + rtol).all(axis=1)
              & (resid < rtol * scale))
    return inside, np.clip(r, 0.0, 1.0)


def sample_h1(fes, u, points, vertices=None):
    """Sample an H1 field at physical points; NaN where not found.

    Mirrors SampleFieldAtPoint (FindPoints + GetValue)."""
    elem_ids, refs = locate_points(fes.mesh, points, vertices)
    u = np.asarray(u)
    out = np.full(len(elem_ids), np.nan)
    found = elem_ids >= 0
    if found.any():
        B, _ = fes.ref.eval(refs[found])        # (nf, ndof)
        dofs = fes.element_dofs[elem_ids[found]]
        out[found] = np.einsum("pn,pn->p", B, u[dofs])
    return out


def sample_h1_fields(fes, fields, points, vertices=None):
    """Sample SEVERAL H1 fields at the same physical points with ONE
    point-location pass; returns a list of (npts,) arrays (NaN where not
    found) in the order of ``fields``."""
    elem_ids, refs = locate_points(fes.mesh, points, vertices)
    found = elem_ids >= 0
    outs = [np.full(len(elem_ids), np.nan) for _ in fields]
    if found.any():
        B, _ = fes.ref.eval(refs[found])
        dofs = fes.element_dofs[elem_ids[found]]
        for out, u in zip(outs, fields):
            out[found] = np.einsum("pn,pn->p", B, np.asarray(u)[dofs])
    return outs


def sample_l2(mesh: Mesh, elem_vals, points, vertices=None):
    """Sample an L2(0) (per-element) field at physical points."""
    elem_ids, _ = locate_points(mesh, points, vertices)
    vals = np.asarray(elem_vals)
    out = np.full(len(elem_ids), np.nan)
    found = elem_ids >= 0
    out[found] = vals[elem_ids[found]]
    return out


def front_depth(mesh: Mesh, elem_vals, x, y_top, y_bottom, threshold,
                ns=250, vertices=None):
    """Depth below y_top where the sampled field first crosses
    `threshold` along a vertical line (ComputeFrontDepth).

    Intentional divergence from the reference: the reference accepts only
    a *decreasing* crossing (``vp > threshold && vc <= threshold``)
    while scanning downward from the
    heated top — but the virgin-mass fraction tau it is applied to
    *increases* with depth once the surface chars, so the
    reference metric returns 0 for its whole validated regime.  We accept
    the first crossing in either direction, which is the FIAT
    pyrolysis-front convention (depth where tau passes the threshold)
    and reduces to the reference exactly whenever a decreasing crossing
    exists."""
    eps = 1e-9
    y0 = y_top - eps
    y1 = y_bottom + eps
    ys = y0 - np.arange(ns + 1) * (y0 - y1) / ns
    pts = np.stack([np.full(ns + 1, x), ys], axis=1)
    vals = sample_l2(mesh, elem_vals, pts, vertices)
    return front_depth_from_line(vals, ys, y_top, threshold)


def front_depth_from_line(vals, ys, y_top, threshold):
    """Crossing detection of ``front_depth`` on precomputed line samples
    (pure numpy — no location pass, no device dispatch)."""
    for k in range(1, len(vals)):
        vp, vc = vals[k - 1], vals[k]
        if (np.isfinite(vp) and np.isfinite(vc)
                and (vp > threshold >= vc or vp < threshold <= vc)):
            denom = vp - vc
            frac = 0.0 if abs(denom) < 1e-14 else \
                np.clip((vp - threshold) / denom, 0.0, 1.0)
            y_cross = ys[k - 1] - frac * (ys[k - 1] - ys[k])
            return max(0.0, y_top - y_cross)
    return 0.0


def front_line_stencil(mesh: Mesh, x, y_top, y_bottom, ns=250,
                       vertices=None):
    """Precompute the front_depth sampling line ONCE for a STATIC mesh
    (the case-1/2.1 scan drivers call front_depth per step; the location
    pass is an O(npts * ne) sweep that dominated their host post-chunk
    loops).  Returns (elem_ids (ns+1,), ys (ns+1,)); per step,
    ``front_depth_static(elem_ids, ys, elem_vals, y_top, thr)``."""
    eps = 1e-9
    y0 = y_top - eps
    y1 = y_bottom + eps
    ys = y0 - np.arange(ns + 1) * (y0 - y1) / ns
    pts = np.stack([np.full(ns + 1, x), ys], axis=1)
    elem_ids, _ = locate_points(mesh, pts, vertices)
    return elem_ids, ys


def front_depth_static(elem_ids, ys, elem_vals, y_top, threshold):
    """front_depth on a precomputed ``front_line_stencil`` (numpy-only
    per-step cost)."""
    vals = np.asarray(elem_vals)
    v = np.where(elem_ids >= 0, vals[np.maximum(elem_ids, 0)], np.nan)
    return front_depth_from_line(v, ys, y_top, threshold)


def sample_h1_grad(fes, u, points, vertices=None):
    """Sample physical gradients of an H1 field at points: (npts, dim),
    NaN rows where not found (probe-stencil diagnostics)."""
    mesh = fes.mesh
    elem_ids, refs = locate_points(mesh, points, vertices)
    u = np.asarray(u)
    verts = np.asarray(mesh.vertices if vertices is None else vertices)
    out = np.full((len(elem_ids), mesh.dim), np.nan)
    found = np.nonzero(elem_ids >= 0)[0]
    if len(found) == 0:
        return out
    from .reference_elements import get_reference_element

    _, G = fes.ref.eval(refs[found])                  # (nf, ndof, dim)
    geo = get_reference_element(mesh.geom, 1)
    _, Gg = geo.eval(refs[found])                     # (nf, nc, dim)
    coords = verts[mesh.elem_conn[elem_ids[found]]]   # (nf, nc, dim)
    J = np.einsum("fnd,fnr->fdr", coords, Gg)
    invJ = np.linalg.inv(J)                           # [r, d] convention
    gref = np.einsum("fnr,fn->fr", G,
                     u[fes.element_dofs[elem_ids[found]]])
    out[found] = np.einsum("frd,fr->fd", invJ, gref)
    return out


def h1_sampling_stencil(fes, points, vertices=None):
    """Precompute a device stencil for repeated H1 sampling at FIXED points
    (the scan-stepping drivers' probe rows): returns numpy
    (dofs (npts, ndof) int64, weights (npts, ndof)) with
    value[i] = sum_n weights[i, n] * u[dofs[i, n]].  Points outside the
    mesh get NaN weights so the sampled value propagates as NaN, matching
    ``sample_h1``."""
    elem_ids, refs = locate_points(fes.mesh, points, vertices)
    npts = len(elem_ids)
    nd = fes.element_dofs.shape[1]
    dofs = np.zeros((npts, nd), dtype=np.int64)
    weights = np.full((npts, nd), np.nan)
    found = elem_ids >= 0
    if found.any():
        B, _ = fes.ref.eval(refs[found])
        dofs[found] = fes.element_dofs[elem_ids[found]]
        weights[found] = B
    return dofs, weights
