"""H1 / L2 finite-element spaces with global DOF enumeration.

Numpy copy of ``cmfem_tpu/core/fespace.py``: the ``ParFiniteElementSpace``
machinery (true-dof numbering, essential dofs, element/boundary DOF maps).

Global H1 DOFs are enumerated entity-by-entity (vertices, then unique edges,
then unique faces for 3D, then element interiors) so shared DOFs coincide
between neighbouring elements.  Edge-interior DOFs are stored in the
direction low-vertex-id -> high-vertex-id; hex-face interiors on a canonical
lattice (start at the min-vertex corner, walk toward its smaller neighbour).
Local->global maps are dense ``int32`` arrays, ready for gather /
``segment_sum`` scatter on device (the T / T^T restriction in SURVEY.md §2.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import Mesh
from .reference_elements import (
    GEOM_EDGES,
    GEOM_FACES,
    FACE_GEOM,
    SEGMENT,
    TRIANGLE,
    QUAD,
    TETRAHEDRON,
    HEXAHEDRON,
    ReferenceElement,
    get_reference_element,
)

_FACE_LATTICE = {  # lattice coords of local face corners (scaled by p)
    0: (0, 0),
    1: (1, 0),
    2: (1, 1),
    3: (0, 1),
}


def _sorted_tuple_keys(*arrays):
    """Collision-free int64 keys for rows of SORTED integer tuples,
    consistent across all inputs (equal tuples get equal keys, distinct
    tuples distinct keys) and lexicographically order-preserving, so
    ``np.unique`` + ``searchsorted`` matching between the returned
    arrays works exactly as with direct base-kmax packing.

    Direct packing ``((k0*kmax + k1)*kmax + k2)*kmax + k3`` overflows
    int64 for 4-tuples once kmax > ~55k vertices (a 48^3 hex mesh
    already wraps) and for 3-tuples above ~2.1M vertices; this
    hierarchically renumbers the running key densely before folding in
    each next column, so the running value stays < n_rows * kmax.
    Arrays must share the same tuple width; one key array per input is
    returned, shaped like ``a[..., 0]``."""
    w = arrays[0].shape[-1]
    rows = np.concatenate(
        [np.ascontiguousarray(a, dtype=np.int64).reshape(-1, w)
         for a in arrays], axis=0)
    ids = rows[:, 0]
    for c in range(1, w):
        _, ids = np.unique(ids, return_inverse=True)   # dense ranks
        ids = ids.astype(np.int64) * (int(rows[:, c].max()) + 1) \
            + rows[:, c]
    outs = []
    off = 0
    for a in arrays:
        cnt = a[..., 0].size
        outs.append(ids[off:off + cnt].reshape(a.shape[:-1]))
        off += cnt
    return outs[0] if len(outs) == 1 else tuple(outs)


def _canonical_edges(conn: np.ndarray, edge_list):
    """Unique mesh edges. Returns (edge_ids (ne, nloc_edges), edge_dirs
    (ne, nloc_edges) ±1, n_edges). Canonical direction: min->max vertex."""
    ne = len(conn)
    nle = len(edge_list)
    a = np.stack([conn[:, e[0]] for e in edge_list], axis=1).astype(np.int64)
    b = np.stack([conn[:, e[1]] for e in edge_list], axis=1).astype(np.int64)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    keys = lo * (conn.max() + 1) + hi
    uniq, inv = np.unique(keys.ravel(), return_inverse=True)
    edge_ids = inv.reshape(ne, nle).astype(np.int64)
    edge_dirs = np.where(a <= b, 1, -1)
    return edge_ids, edge_dirs, len(uniq)


def _canonical_tri_faces(conn: np.ndarray, face_list):
    """Unique triangle faces of tets: (face_ids (ne, 4), n_faces).
    Ids follow the sorted-vertex-key unique ordering (matching the
    boundary-face lookup in FESpace._build_boundary)."""
    g = np.stack([conn[:, list(f)] for f in face_list], 1).astype(np.int64)
    key = np.sort(g, axis=2)
    flat = _sorted_tuple_keys(key)
    uniq, inv = np.unique(flat.ravel(), return_inverse=True)
    return inv.reshape(flat.shape), len(uniq)


def _tri_face_node_bary(p: int):
    """Barycentric integer exponents of the triangle face-interior nodes in
    reference-element enumeration order: (p-i-j, i, j) for i in 1..p-1,
    j in 1..p-i-1 (matches the tet node generation in
    reference_elements.py)."""
    return [(p - i - j, i, j) for i in range(1, p) for j in range(1, p - i)]


def _tri_face_canonical_indices(corners: np.ndarray, p: int):
    """For faces given by global corner ids (nf, 3) in a LOCAL ordering,
    return (nf, fpe) canonical face-node indices: node t (barycentric bl in
    local corner order) maps to the node whose barycentric tuple, expressed
    in ascending-global-vertex (canonical) corner order, appears at that
    enumeration position.  Orientation-free nodes (all exponents equal) map
    to themselves."""
    bary = _tri_face_node_bary(p)
    lookup = {b: t for t, b in enumerate(bary)}
    fpe = len(bary)
    nf = len(corners)
    out = np.zeros((nf, fpe), dtype=np.int64)
    order = np.argsort(corners, axis=1)  # order[k] = local pos of k-th smallest
    import itertools

    for perm in itertools.permutations(range(3)):
        mask = (order == np.asarray(perm)).all(axis=1)
        if not mask.any():
            continue
        for t, bl in enumerate(bary):
            bc = (bl[perm[0]], bl[perm[1]], bl[perm[2]])
            out[mask, t] = lookup[bc]
    return out


def _canonical_faces(conn: np.ndarray, face_list):
    """Unique quad faces of hexes.

    Returns (face_ids (ne, 6), face_perm_start (ne,6), face_perm_dir (ne,6),
    n_faces, face_corner_ids (nf, 4) canonical corners).
    """
    ne = len(conn)
    nlf = len(face_list)
    g = np.stack(
        [conn[:, list(f)] for f in face_list], axis=1
    ).astype(np.int64)  # (ne, 6, 4)
    key = np.sort(g, axis=2)
    flat = _sorted_tuple_keys(key)
    uniq, first_idx, inv = np.unique(flat.ravel(), return_index=True, return_inverse=True)
    face_ids = inv.reshape(ne, nlf)
    # canonical orientation per face instance
    s = np.argmin(g, axis=2)  # (ne, 6) position of min corner
    nxt = np.take_along_axis(g, ((s + 1) % 4)[..., None], axis=2)[..., 0]
    prv = np.take_along_axis(g, ((s - 1) % 4)[..., None], axis=2)[..., 0]
    d = np.where(nxt < prv, 1, -1)
    # canonical corner list of each unique face (from the first instance seen)
    g_flat = g.reshape(-1, 4)
    s_flat = s.ravel()
    d_flat = d.ravel()
    fc = np.zeros((len(uniq), 4), dtype=np.int64)
    sel = first_idx
    idx = (s_flat[sel][:, None] + d_flat[sel][:, None] * np.arange(4)[None, :]) % 4
    fc = np.take_along_axis(g_flat[sel], idx, axis=1)
    return face_ids, s, d, len(uniq), fc


@dataclass
class BoundaryFaces:
    """Per-attribute-agnostic boundary face data for surface integrals."""

    geom: str | None  # face geometry (segment / quad)
    dofs: np.ndarray  # (nbf, nfdof) global dofs in face-element local order
    corner_verts: np.ndarray  # (nbf, ncorner) mesh vertex ids
    attr: np.ndarray  # (nbf,)
    elem: np.ndarray  # (nbf,) adjacent element index
    normal_sign: np.ndarray  # (nbf,) ±1 so that sign * geometric normal is outward


class FESpace:
    """Scalar or vector H1 Lagrange space (orders 1..4) or L2(0) space.

    Vector spaces use byNODES ordering: dof(node, comp) = comp*nscalar + node.
    """

    def __init__(self, mesh: Mesh, order: int, vdim: int = 1, kind: str = "H1"):
        self.mesh = mesh
        self.order = order
        self.vdim = vdim
        self.kind = kind
        if kind == "H1" and not 1 <= order <= 4:
            raise ValueError(f"H1 spaces support orders 1..4, got {order}")
        if kind == "L2":
            if order != 0:
                raise NotImplementedError("L2 spaces only at order 0")
            self.ref = None
            self.nscalar = mesh.num_elements
            self.element_dofs = np.arange(mesh.num_elements, dtype=np.int32)[:, None]
            self.bdr = None
            self.node_positions = None
            return
        self.ref: ReferenceElement = get_reference_element(mesh.geom, order)
        self._build_h1()

    # -- H1 construction ---------------------------------------------------

    def _build_h1(self):
        mesh, p, ref = self.mesh, self.order, self.ref
        conn = mesh.elem_conn.astype(np.int64)
        ne = mesh.num_elements
        nvert = mesh.num_vertices
        edge_list = GEOM_EDGES[mesh.geom]
        nle = len(edge_list)
        epe = p - 1  # edge dofs per edge

        edge_ids, edge_dirs, n_edges = (
            _canonical_edges(conn, edge_list) if nle else (None, None, 0)
        )

        has_faces = mesh.geom in (HEXAHEDRON, TETRAHEDRON)
        if mesh.geom == HEXAHEDRON:
            face_list = GEOM_FACES[HEXAHEDRON]
            fids, fs, fd, n_faces, face_corners = _canonical_faces(conn, face_list)
            fpe = (p - 1) ** 2
        elif mesh.geom == TETRAHEDRON:
            face_list = GEOM_FACES[TETRAHEDRON]
            fs = fd = face_corners = None
            fpe = (p - 1) * (p - 2) // 2
            if fpe == 0:
                fids, n_faces = None, 0
            else:
                # shared-face ids + per-(element, local face) canonical
                # node indices (p=3's single centroid node is trivially
                # orientation-free; p=4's three nodes permute with the
                # corner ordering)
                fids, n_faces = _canonical_tri_faces(conn, face_list)
        else:
            face_list = []
            fids = fs = fd = face_corners = None
            n_faces, fpe = 0, 0

        n_int = ref.n_interior_dofs
        off_edge = nvert
        off_face = off_edge + n_edges * epe
        off_int = off_face + n_faces * fpe
        self.nscalar = off_int + ne * n_int
        self._n_edges = n_edges
        self._edge_ids = edge_ids
        self._edge_dirs = edge_dirs
        self._off_edge = off_edge
        self._off_face = off_face
        self._off_int = off_int

        eldofs = np.zeros((ne, ref.ndof), dtype=np.int64)
        nvloc = conn.shape[1]
        eldofs[:, :nvloc] = conn
        col = nvloc
        # edge interiors
        for le in range(nle):
            ids = edge_ids[:, le]
            dirs = edge_dirs[:, le]
            for k in range(epe):
                kk = np.where(dirs == 1, k, epe - 1 - k)
                eldofs[:, col + k] = off_edge + ids * epe + kk
            col += epe
        # hex face interiors
        if mesh.geom == HEXAHEDRON and fpe > 0:
            L = np.array([[0, 0], [p, 0], [p, p], [0, p]], dtype=np.int64)
            for lf in range(len(face_list)):
                ids = fids[:, lf]
                s = fs[:, lf]
                d = fd[:, lf]
                base = L[s]  # (ne, 2) canonical origin in local lattice
                e1 = (L[(s + d) % 4] - base) // p  # (ne,2) unit axis
                e2 = (L[(s - d) % 4] - base) // p
                k = 0
                for j in range(1, p):
                    for i in range(1, p):
                        ij = np.array([i, j])
                        aa = (ij[None, 0] - base[:, 0]) * e1[:, 0] + (
                            ij[None, 1] - base[:, 1]
                        ) * e1[:, 1]
                        bb = (ij[None, 0] - base[:, 0]) * e2[:, 0] + (
                            ij[None, 1] - base[:, 1]
                        ) * e2[:, 1]
                        canon_lin = (bb - 1) * (p - 1) + (aa - 1)
                        eldofs[:, col + k] = off_face + ids * fpe + canon_lin
                        k += 1
                col += fpe
        # tet face interiors: canonical (sorted-vertex) barycentric ordering
        if mesh.geom == TETRAHEDRON and fpe > 0:
            for lf in range(len(face_list)):
                corners = conn[:, list(face_list[lf])]
                canon = _tri_face_canonical_indices(corners, p)  # (ne, fpe)
                for t in range(fpe):
                    eldofs[:, col + t] = off_face + fids[:, lf] * fpe + \
                        canon[:, t]
                col += fpe
        # interiors
        if n_int:
            eldofs[:, col:col + n_int] = (
                off_int
                + np.arange(ne, dtype=np.int64)[:, None] * n_int
                + np.arange(n_int)[None, :]
            )
        self.element_dofs = eldofs.astype(np.int32)

        # node positions (geometry: multilinear map from corner vertices)
        self.node_positions = self._compute_node_positions()

        # boundary faces
        self.bdr = self._build_boundary()

    def _compute_node_positions(self) -> np.ndarray:
        """(nscalar, dim) physical positions of the scalar DOF nodes."""
        mesh, ref = self.mesh, self.ref
        corners = mesh.vertices[mesh.elem_conn]  # (ne, nc, dim)
        # geometry basis: order-1 element of same geom at ref node positions
        geo = get_reference_element(mesh.geom, 1)
        Bg, _ = geo.eval(ref.nodes)  # (ndof, nc)
        el_pos = np.einsum("nc,ecd->end", Bg, corners)  # (ne, ndof, dim)
        pos = np.zeros((self.nscalar, mesh.dim))
        pos[self.element_dofs.reshape(-1)] = el_pos.reshape(-1, mesh.dim)
        return pos

    def _build_boundary(self) -> BoundaryFaces:
        mesh, p = self.mesh, self.order
        nbf = mesh.num_bdr_faces
        fgeom = FACE_GEOM[mesh.geom]
        if nbf == 0:
            return BoundaryFaces(fgeom, np.zeros((0, 0), np.int32),
                                 mesh.bdr_conn, mesh.bdr_attr,
                                 np.zeros(0, np.int64), np.ones(0))
        conn = mesh.bdr_conn.astype(np.int64)
        epe = p - 1
        if fgeom == SEGMENT:
            # dofs: v0, v1, edge interior (directed v0->v1)
            kmax = int(mesh.elem_conn.max()) + 1
            lo = np.minimum(conn[:, 0], conn[:, 1])
            hi = np.maximum(conn[:, 0], conn[:, 1])
            # map to unique-edge ids of the volume mesh
            vol_edges = GEOM_EDGES[mesh.geom]
            a = np.stack([mesh.elem_conn[:, e[0]] for e in vol_edges], 1).astype(np.int64)
            b = np.stack([mesh.elem_conn[:, e[1]] for e in vol_edges], 1).astype(np.int64)
            vk = np.minimum(a, b) * kmax + np.maximum(a, b)
            uniq = np.unique(vk.ravel())
            bk = lo * kmax + hi
            eid = np.searchsorted(uniq, bk)
            ok = uniq[np.clip(eid, 0, len(uniq) - 1)] == bk
            if not ok.all():
                raise ValueError("Boundary edge not found among element edges")
            dirs = np.where(conn[:, 0] <= conn[:, 1], 1, -1)
            nfdof = 2 + epe
            dofs = np.zeros((nbf, nfdof), dtype=np.int64)
            dofs[:, 0] = conn[:, 0]
            dofs[:, 1] = conn[:, 1]
            for k in range(epe):
                kk = np.where(dirs == 1, k, epe - 1 - k)
                dofs[:, 2 + k] = self._off_edge + eid * epe + kk
        elif fgeom == QUAD:
            face_list = GEOM_FACES[HEXAHEDRON]
            # recompute unique volume faces to map boundary faces
            g = np.stack([mesh.elem_conn[:, list(f)] for f in face_list], 1).astype(np.int64)
            key = np.sort(g, axis=2)
            kmax = int(mesh.elem_conn.max()) + 1
            # joint packing keeps volume/boundary keys comparable
            flat, bflat = _sorted_tuple_keys(key, np.sort(conn, axis=1))
            uniq = np.unique(flat.ravel())
            fid = np.searchsorted(uniq, bflat)
            if not (uniq[np.clip(fid, 0, len(uniq) - 1)] == bflat).all():
                raise ValueError("Boundary face not found among element faces")
            # edges of the boundary face
            vol_edges = GEOM_EDGES[HEXAHEDRON]
            a = np.stack([mesh.elem_conn[:, e[0]] for e in vol_edges], 1).astype(np.int64)
            b = np.stack([mesh.elem_conn[:, e[1]] for e in vol_edges], 1).astype(np.int64)
            ek = np.minimum(a, b) * kmax + np.maximum(a, b)
            euniq = np.unique(ek.ravel())
            face_edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
            fpe = (p - 1) ** 2
            fref = get_reference_element(QUAD, p)
            nfdof = fref.ndof
            dofs = np.zeros((nbf, nfdof), dtype=np.int64)
            dofs[:, :4] = conn
            col = 4
            for (la, lb) in face_edges:
                ea, eb = conn[:, la], conn[:, lb]
                bk = np.minimum(ea, eb) * kmax + np.maximum(ea, eb)
                eid = np.searchsorted(euniq, bk)
                if not (euniq[np.clip(eid, 0, len(euniq) - 1)] == bk).all():
                    raise ValueError("Boundary face edge not found")
                dirs = np.where(ea <= eb, 1, -1)
                for k in range(epe):
                    kk = np.where(dirs == 1, k, epe - 1 - k)
                    dofs[:, col + k] = self._off_edge + eid * epe + kk
                col += epe
            if fpe > 0:
                # orientation of boundary-face lattice vs canonical face lattice
                s = np.argmin(conn, axis=1)
                nxt = np.take_along_axis(conn, ((s + 1) % 4)[:, None], 1)[:, 0]
                prv = np.take_along_axis(conn, ((s - 1) % 4)[:, None], 1)[:, 0]
                d = np.where(nxt < prv, 1, -1)
                L = np.array([[0, 0], [p, 0], [p, p], [0, p]], dtype=np.int64)
                base = L[s]
                e1 = (L[(s + d) % 4] - base) // p
                e2 = (L[(s - d) % 4] - base) // p
                k = 0
                for j in range(1, p):
                    for i in range(1, p):
                        aa = (i - base[:, 0]) * e1[:, 0] + (j - base[:, 1]) * e1[:, 1]
                        bb = (i - base[:, 0]) * e2[:, 0] + (j - base[:, 1]) * e2[:, 1]
                        canon_lin = (bb - 1) * (p - 1) + (aa - 1)
                        dofs[:, col + k] = self._off_face + fid * fpe + canon_lin
                        k += 1
                col += fpe
        elif fgeom == TRIANGLE:
            face_list = GEOM_FACES[TETRAHEDRON]
            g = np.stack([mesh.elem_conn[:, list(f)] for f in face_list],
                         1).astype(np.int64)
            key = np.sort(g, axis=2)
            kmax = int(mesh.elem_conn.max()) + 1
            flat, bflat = _sorted_tuple_keys(key, np.sort(conn, axis=1))
            uniq = np.unique(flat.ravel())
            fid = np.searchsorted(uniq, bflat)
            if not (uniq[np.clip(fid, 0, len(uniq) - 1)] == bflat).all():
                raise ValueError("Boundary face not found among element faces")
            vol_edges = GEOM_EDGES[TETRAHEDRON]
            a = np.stack([mesh.elem_conn[:, e[0]] for e in vol_edges],
                         1).astype(np.int64)
            b = np.stack([mesh.elem_conn[:, e[1]] for e in vol_edges],
                         1).astype(np.int64)
            ek = np.minimum(a, b) * kmax + np.maximum(a, b)
            euniq = np.unique(ek.ravel())
            face_edges = GEOM_EDGES[TRIANGLE]
            fpe = (p - 1) * (p - 2) // 2
            fref = get_reference_element(TRIANGLE, p)
            nfdof = fref.ndof
            dofs = np.zeros((nbf, nfdof), dtype=np.int64)
            dofs[:, :3] = conn
            col = 3
            for (la, lb) in face_edges:
                ea, eb = conn[:, la], conn[:, lb]
                bk = np.minimum(ea, eb) * kmax + np.maximum(ea, eb)
                eid = np.searchsorted(euniq, bk)
                if not (euniq[np.clip(eid, 0, len(euniq) - 1)] == bk).all():
                    raise ValueError("Boundary face edge not found")
                dirs = np.where(ea <= eb, 1, -1)
                for k in range(epe):
                    kk = np.where(dirs == 1, k, epe - 1 - k)
                    dofs[:, col + k] = self._off_edge + eid * epe + kk
                col += epe
            if fpe >= 1:
                # face-interior nodes in canonical (sorted-vertex)
                # barycentric order; the boundary element enumerates its
                # nodes in bdr_conn corner order
                canon = _tri_face_canonical_indices(conn, p)
                for t in range(fpe):
                    dofs[:, col + t] = self._off_face + fid * fpe + \
                        canon[:, t]
                col += fpe
        else:
            raise NotImplementedError(fgeom)

        bdr_elem, normal_sign = self._boundary_adjacency()
        return BoundaryFaces(fgeom, dofs.astype(np.int32), mesh.bdr_conn,
                             mesh.bdr_attr, bdr_elem, normal_sign)

    def _boundary_adjacency(self):
        """Adjacent element per boundary face + outward-normal sign."""
        mesh = self.mesh
        conn = mesh.elem_conn.astype(np.int64)
        from .reference_elements import GEOM_BOUNDARY

        flist = GEOM_BOUNDARY[mesh.geom]
        fverts = np.stack(
            [np.sort(conn[:, list(f)], axis=1) for f in flist],
            axis=1)  # (ne, nlf, w)
        bconn = mesh.bdr_conn.astype(np.int64)
        keys, bkey = _sorted_tuple_keys(fverts, np.sort(bconn, axis=1))
        flat = keys.ravel()
        order_ = np.argsort(flat, kind="stable")
        sorted_keys = flat[order_]
        pos = np.searchsorted(sorted_keys, bkey)
        if not (sorted_keys[np.clip(pos, 0, len(sorted_keys) - 1)] == bkey).all():
            raise ValueError("Boundary face has no adjacent element")
        elem = (order_[pos] // keys.shape[1]).astype(np.int64)

        # outward sign: geometric normal of the face param vs centroid offset
        centroids = mesh.vertices[mesh.elem_conn].mean(axis=1)[elem]
        fc = mesh.vertices[bconn].mean(axis=1)
        if mesh.dim == 2:
            t = mesh.vertices[bconn[:, 1]] - mesh.vertices[bconn[:, 0]]
            nrm = np.stack([t[:, 1], -t[:, 0]], axis=1)
        else:
            # last cycle vertex: index 3 for quad faces, 2 for triangles —
            # matches the order-1 face parametrization tangents d/ds, d/dt
            u = mesh.vertices[bconn[:, 1]] - mesh.vertices[bconn[:, 0]]
            v = mesh.vertices[bconn[:, bconn.shape[1] - 1]] \
                - mesh.vertices[bconn[:, 0]]
            nrm = np.cross(u, v)
        sign = np.where(np.einsum("fd,fd->f", nrm, fc - centroids) > 0, 1.0, -1.0)
        return elem, sign

    # -- public API --------------------------------------------------------

    @property
    def num_dofs(self) -> int:
        return self.nscalar * self.vdim

    def vdof(self, scalar_dofs, comp: int):
        """Vector-space dof ids for component `comp` (byNODES ordering)."""
        return np.asarray(scalar_dofs) + comp * self.nscalar

    def boundary_dofs(self, attr_marker=None) -> np.ndarray:
        """Unique scalar DOFs on boundary faces whose attribute is marked.

        attr_marker: None (all attributes) or iterable of attribute ids.
        Mirrors ``GetEssentialTrueDofs``."""
        if self.bdr is None or len(self.bdr.attr) == 0:
            return np.zeros(0, dtype=np.int32)
        if attr_marker is None:
            mask = np.ones(len(self.bdr.attr), dtype=bool)
        else:
            attrs = np.asarray(list(attr_marker))
            mask = np.isin(self.bdr.attr, attrs)
        return np.unique(self.bdr.dofs[mask].ravel()).astype(np.int32)

    def essential_dofs(self, attr_marker=None, components=None) -> np.ndarray:
        """Essential (Dirichlet) dof list, expanded over vector components."""
        sd = self.boundary_dofs(attr_marker)
        if self.vdim == 1:
            return sd
        comps = range(self.vdim) if components is None else components
        return np.concatenate([self.vdof(sd, c) for c in comps]).astype(np.int32)

    def interpolate(self, fn, time=None) -> np.ndarray:
        """Nodal interpolation of a callable fn(points[, t]) -> values.

        Mirrors MFEM ``ProjectCoefficient`` for Lagrange H1 spaces.
        fn receives an (n, dim) array and returns (n,) (scalar space) or
        (n, vdim)."""
        pts = self.node_positions
        vals = fn(pts) if time is None else fn(pts, time)
        vals = np.asarray(vals)
        if self.vdim == 1:
            return vals.reshape(-1)
        return vals.T.reshape(-1)  # byNODES

    def project_bdr(self, u: np.ndarray, fn, attr_marker=None, time=None):
        """Overwrite boundary DOFs of u with nodal values of fn (in place copy).

        Mirrors ``ProjectBdrCoefficient``."""
        sd = self.boundary_dofs(attr_marker)
        u = np.array(u)
        pts = self.node_positions[sd]
        vals = fn(pts) if time is None else fn(pts, time)
        vals = np.asarray(vals)
        if self.vdim == 1:
            u[sd] = vals.reshape(-1)
        else:
            for c in range(self.vdim):
                u[self.vdof(sd, c)] = vals[:, c]
        return u
