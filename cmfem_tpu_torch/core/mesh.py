"""Mesh: SoA arrays + GMSH v2.2 reader + uniform refinement.

Numpy copy of ``cmfem_tpu/core/mesh.py`` (MFEM's ``Mesh`` layer: the Gmsh
reader and uniform refinement).  Data lives in plain numpy arrays;
device-side consumers (assembly, geometry) receive them as torch tensors.
The copy keeps only the pure-Python gmsh reader: the JAX package's optional
native parser is not carried over.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, replace

import numpy as np

from .reference_elements import (
    SEGMENT,
    TRIANGLE,
    QUAD,
    TETRAHEDRON,
    HEXAHEDRON,
    GEOM_DIM,
)

# GMSH element type id -> (geometry, n corner nodes)
_GMSH_TYPES = {
    1: (SEGMENT, 2),
    2: (TRIANGLE, 3),
    3: (QUAD, 4),
    4: (TETRAHEDRON, 4),
    5: (HEXAHEDRON, 8),
    8: (SEGMENT, 2),   # line3: keep corners
    9: (TRIANGLE, 3),  # tri6
    10: (QUAD, 4),     # quad9
    15: (None, 1),     # point
}


@dataclass(frozen=True)
class Mesh:
    """An unstructured mesh with one volume element type.

    vertices : (nv, dim) float64
    elem_conn : (ne, nverts) int32 corner connectivity
    elem_attr : (ne,) int32 physical attributes
    bdr_conn : (nbf, nfverts) int32 boundary-face corner connectivity
    bdr_attr : (nbf,) int32 boundary attributes
    """

    dim: int
    geom: str
    vertices: np.ndarray
    elem_conn: np.ndarray
    elem_attr: np.ndarray
    bdr_geom: str | None
    bdr_conn: np.ndarray
    bdr_attr: np.ndarray

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_elements(self) -> int:
        return len(self.elem_conn)

    @property
    def num_bdr_faces(self) -> int:
        return len(self.bdr_conn)

    @property
    def bdr_attributes(self) -> np.ndarray:
        """Sorted unique boundary attributes present in the mesh."""
        return np.unique(self.bdr_attr) if len(self.bdr_attr) else np.array([], np.int32)

    def bounding_box(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def uniform_refine(self, levels: int = 1) -> "Mesh":
        m = self
        for _ in range(levels):
            m = _refine_once(m)
        return m

    def with_vertices(self, vertices: np.ndarray) -> "Mesh":
        return replace(self, vertices=np.asarray(vertices, dtype=np.float64))


def load_gmsh(path_or_str, keep_z: bool = False) -> Mesh:
    """Read a GMSH v2.2 ASCII mesh (the format of all reference assets),
    from a path or from the file's text."""
    if isinstance(path_or_str, str) and "$MeshFormat" in path_or_str:
        f = io.StringIO(path_or_str)
    else:
        f = open(path_or_str, "r")
    with f:
        lines = f.read().splitlines()

    i = 0
    node_ids = []
    node_xyz = []
    elems = []  # (type, phys, [node ids])
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            ver = lines[i + 1].split()[0]
            if not ver.startswith("2."):
                raise ValueError(f"Only GMSH v2.x supported, got {ver}")
            i += 3
        elif line == "$Nodes":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                node_ids.append(int(parts[0]))
                node_xyz.append([float(parts[1]), float(parts[2]), float(parts[3])])
            i += n + 3
        elif line == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype = int(parts[1])
                ntags = int(parts[2])
                phys = int(parts[3]) if ntags >= 1 else 0
                nodes = [int(x) for x in parts[3 + ntags:]]
                elems.append((etype, phys, nodes))
            i += n + 3
        elif line.startswith("$"):
            # skip section
            end = "$End" + line[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != end:
                j += 1
            i = j + 1
        else:
            i += 1

    node_ids = np.asarray(node_ids)
    xyz = np.asarray(node_xyz, dtype=np.float64)
    id2idx = np.full(node_ids.max() + 1, -1, dtype=np.int64)
    id2idx[node_ids] = np.arange(len(node_ids))

    by_geom: dict[str, list] = {}
    for etype, phys, nodes in elems:
        if etype not in _GMSH_TYPES:
            raise ValueError(f"Unsupported GMSH element type {etype}")
        geom, ncorner = _GMSH_TYPES[etype]
        if geom is None:
            continue
        conn = id2idx[np.asarray(nodes[:ncorner])]
        by_geom.setdefault(geom, []).append((phys, conn))

    dims = {GEOM_DIM[g] for g in by_geom}
    dim = max(dims)
    vol_geoms = [g for g in by_geom if GEOM_DIM[g] == dim]
    if len(vol_geoms) != 1:
        raise ValueError(f"Mixed volume element types unsupported: {vol_geoms}")
    geom = vol_geoms[0]
    vol = by_geom[geom]
    elem_conn = np.asarray([c for _, c in vol], dtype=np.int32)
    elem_attr = np.asarray([p for p, _ in vol], dtype=np.int32)

    bdr_geoms = [g for g in by_geom if GEOM_DIM[g] == dim - 1]
    if bdr_geoms:
        if len(bdr_geoms) != 1:
            raise ValueError(f"Mixed boundary element types: {bdr_geoms}")
        bg = bdr_geoms[0]
        bdr = by_geom[bg]
        bdr_conn = np.asarray([c for _, c in bdr], dtype=np.int32)
        bdr_attr = np.asarray([p for p, _ in bdr], dtype=np.int32)
    else:
        bg = None
        bdr_conn = np.zeros((0, 2 if dim == 2 else 4), dtype=np.int32)
        bdr_attr = np.zeros((0,), dtype=np.int32)

    verts = xyz[:, :dim] if not keep_z else xyz
    return _finalize_mesh(dim, geom, verts, elem_conn, elem_attr, bg,
                          bdr_conn, bdr_attr)


def _finalize_mesh(dim, geom, verts, elem_conn, elem_attr, bg, bdr_conn,
                   bdr_attr) -> Mesh:
    # Drop nodes not referenced by any element (gmsh sometimes emits extras)
    used = np.zeros(len(verts), dtype=bool)
    used[elem_conn.ravel()] = True
    if len(bdr_conn):
        used[bdr_conn.ravel()] = True
    if not used.all():
        remap = -np.ones(len(verts), dtype=np.int64)
        remap[used] = np.arange(used.sum())
        verts = verts[used]
        elem_conn = remap[elem_conn].astype(np.int32)
        if len(bdr_conn):
            bdr_conn = remap[bdr_conn].astype(np.int32)

    return Mesh(dim, geom, verts, np.asarray(elem_conn, dtype=np.int32),
                np.asarray(elem_attr, dtype=np.int32), bg,
                np.asarray(bdr_conn, dtype=np.int32),
                np.asarray(bdr_attr, dtype=np.int32))


# ---------------------------------------------------------------------------
# Structured mesh generators (for tests, 3D benchmarks, and smoke problems)
# ---------------------------------------------------------------------------

def make_cartesian_mesh_2d(nx: int, ny: int, sx=1.0, sy=1.0, x0=0.0, y0=0.0,
                           geom: str = QUAD) -> Mesh:
    """Structured quad (or tri) mesh on [x0, x0+sx] x [y0, y0+sy].

    Boundary attributes: 1=bottom, 2=right, 3=top, 4=left (matching the
    reference unit-square mesh physical names)."""
    xs = np.linspace(x0, x0 + sx, nx + 1)
    ys = np.linspace(y0, y0 + sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return j * (nx + 1) + i

    quads = []
    for j in range(ny):
        for i in range(nx):
            quads.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    quads = np.asarray(quads, dtype=np.int32)

    bdr_conn, bdr_attr = [], []
    for i in range(nx):
        bdr_conn.append([vid(i, 0), vid(i + 1, 0)]); bdr_attr.append(1)
        bdr_conn.append([vid(i, ny), vid(i + 1, ny)]); bdr_attr.append(3)
    for j in range(ny):
        bdr_conn.append([vid(nx, j), vid(nx, j + 1)]); bdr_attr.append(2)
        bdr_conn.append([vid(0, j), vid(0, j + 1)]); bdr_attr.append(4)
    bdr_conn = np.asarray(bdr_conn, dtype=np.int32)
    bdr_attr = np.asarray(bdr_attr, dtype=np.int32)

    if geom == QUAD:
        conn = quads
    elif geom == TRIANGLE:
        tris = []
        for q in quads:
            tris.append([q[0], q[1], q[2]])
            tris.append([q[0], q[2], q[3]])
        conn = np.asarray(tris, dtype=np.int32)
    else:
        raise ValueError(geom)
    attr = np.ones(len(conn), dtype=np.int32)
    return Mesh(2, geom, verts, conn, attr, SEGMENT, bdr_conn, bdr_attr)


def make_cartesian_mesh_3d(nx: int, ny: int, nz: int, sx=1.0, sy=1.0, sz=1.0) -> Mesh:
    """Structured hex mesh on [0,sx]x[0,sy]x[0,sz].

    Boundary attributes: 1=z0, 2=z1, 3=y0, 4=x1, 5=y1, 6=x0."""
    xs = np.linspace(0, sx, nx + 1)
    ys = np.linspace(0, sy, ny + 1)
    zs = np.linspace(0, sz, nz + 1)
    verts = np.array([(x, y, z) for z in zs for y in ys for x in xs])

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    hexes = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                hexes.append([
                    vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                    vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                    vid(i, j + 1, k + 1),
                ])
    conn = np.asarray(hexes, dtype=np.int32)
    attr = np.ones(len(conn), dtype=np.int32)

    bdr_conn, bdr_attr = [], []
    for j in range(ny):
        for i in range(nx):
            bdr_conn.append([vid(i, j, 0), vid(i, j + 1, 0), vid(i + 1, j + 1, 0), vid(i + 1, j, 0)])
            bdr_attr.append(1)
            bdr_conn.append([vid(i, j, nz), vid(i + 1, j, nz), vid(i + 1, j + 1, nz), vid(i, j + 1, nz)])
            bdr_attr.append(2)
    for k in range(nz):
        for i in range(nx):
            bdr_conn.append([vid(i, 0, k), vid(i + 1, 0, k), vid(i + 1, 0, k + 1), vid(i, 0, k + 1)])
            bdr_attr.append(3)
            bdr_conn.append([vid(i, ny, k), vid(i, ny, k + 1), vid(i + 1, ny, k + 1), vid(i + 1, ny, k)])
            bdr_attr.append(5)
    for k in range(nz):
        for j in range(ny):
            bdr_conn.append([vid(nx, j, k), vid(nx, j + 1, k), vid(nx, j + 1, k + 1), vid(nx, j, k + 1)])
            bdr_attr.append(4)
            bdr_conn.append([vid(0, j, k), vid(0, j, k + 1), vid(0, j + 1, k + 1), vid(0, j + 1, k)])
            bdr_attr.append(6)
    bdr_conn = np.asarray(bdr_conn, dtype=np.int32)
    bdr_attr = np.asarray(bdr_attr, dtype=np.int32)
    return Mesh(3, HEXAHEDRON, verts, conn, attr, QUAD, bdr_conn, bdr_attr)


# ---------------------------------------------------------------------------
# Uniform refinement (quad / tri / hex), matching MFEM UniformRefinement
# semantics (each element splits into 2^dim children; boundary faces split).
# ---------------------------------------------------------------------------

def _edge_key(a, b):
    return (a, b) if a < b else (b, a)


def _refine_once(m: Mesh) -> Mesh:
    if m.geom == QUAD:
        return _refine_quad(m)
    if m.geom == TRIANGLE:
        return _refine_tri(m)
    if m.geom == HEXAHEDRON:
        return _refine_hex(m)
    if m.geom == TETRAHEDRON:
        return _refine_tet(m)
    raise NotImplementedError(f"uniform_refine for {m.geom}")


def _collect_edges(conn, edge_list):
    """Unique edges of the mesh; returns dict {key: new_vertex_index_offset}."""
    keys = {}
    for e in conn:
        for (a, b) in edge_list:
            k = _edge_key(e[a], e[b])
            if k not in keys:
                keys[k] = len(keys)
    return keys


def _refine_quad(m: Mesh) -> Mesh:
    edge_list = [(0, 1), (1, 2), (2, 3), (3, 0)]
    edges = _collect_edges(m.elem_conn, edge_list)
    nv = m.num_vertices
    ne = len(edges)
    new_verts = np.zeros((nv + ne + m.num_elements, m.vertices.shape[1]))
    new_verts[:nv] = m.vertices
    for (a, b), k in edges.items():
        new_verts[nv + k] = 0.5 * (m.vertices[a] + m.vertices[b])
    cen0 = nv + ne
    conn_out, attr_out = [], []
    for ei, e in enumerate(m.elem_conn):
        new_verts[cen0 + ei] = m.vertices[e].mean(axis=0)
        mids = [nv + edges[_edge_key(e[a], e[b])] for (a, b) in edge_list]
        c = cen0 + ei
        v0, v1, v2, v3 = e
        m01, m12, m23, m30 = mids
        conn_out += [
            [v0, m01, c, m30],
            [m01, v1, m12, c],
            [c, m12, v2, m23],
            [m30, c, m23, v3],
        ]
        attr_out += [m.elem_attr[ei]] * 4
    bdr_conn, bdr_attr = [], []
    for bi, f in enumerate(m.bdr_conn):
        k = _edge_key(f[0], f[1])
        if k in edges:
            mid = nv + edges[k]
            bdr_conn += [[f[0], mid], [mid, f[1]]]
            bdr_attr += [m.bdr_attr[bi]] * 2
    return Mesh(2, QUAD, new_verts, np.asarray(conn_out, np.int32),
                np.asarray(attr_out, np.int32), SEGMENT,
                np.asarray(bdr_conn, np.int32), np.asarray(bdr_attr, np.int32))


def _refine_tri(m: Mesh) -> Mesh:
    edge_list = [(0, 1), (1, 2), (2, 0)]
    edges = _collect_edges(m.elem_conn, edge_list)
    nv = m.num_vertices
    new_verts = np.zeros((nv + len(edges), m.vertices.shape[1]))
    new_verts[:nv] = m.vertices
    for (a, b), k in edges.items():
        new_verts[nv + k] = 0.5 * (m.vertices[a] + m.vertices[b])
    conn_out, attr_out = [], []
    for ei, e in enumerate(m.elem_conn):
        v0, v1, v2 = e
        m01 = nv + edges[_edge_key(v0, v1)]
        m12 = nv + edges[_edge_key(v1, v2)]
        m20 = nv + edges[_edge_key(v2, v0)]
        conn_out += [
            [v0, m01, m20], [m01, v1, m12], [m20, m12, v2], [m01, m12, m20],
        ]
        attr_out += [m.elem_attr[ei]] * 4
    bdr_conn, bdr_attr = [], []
    for bi, f in enumerate(m.bdr_conn):
        k = _edge_key(f[0], f[1])
        if k in edges:
            mid = nv + edges[k]
            bdr_conn += [[f[0], mid], [mid, f[1]]]
            bdr_attr += [m.bdr_attr[bi]] * 2
    return Mesh(2, TRIANGLE, new_verts, np.asarray(conn_out, np.int32),
                np.asarray(attr_out, np.int32), SEGMENT,
                np.asarray(bdr_conn, np.int32), np.asarray(bdr_attr, np.int32))


def _refine_tet(m: Mesh) -> Mesh:
    """Red refinement: 4 corner tets + the inner octahedron split into 4
    along its SHORTEST diagonal (1 -> 8 children, volume preserving).  The
    shortest-diagonal rule keeps the shape quality of descendants bounded
    (a fixed diagonal degrades q_min geometrically on anisotropic tets)."""
    edge_list = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    edges = _collect_edges(m.elem_conn, edge_list)
    nv = m.num_vertices
    new_verts = np.zeros((nv + len(edges), 3))
    new_verts[:nv] = m.vertices
    for (a, b), k in edges.items():
        new_verts[nv + k] = 0.5 * (m.vertices[a] + m.vertices[b])
    # equator cycles around each diagonal (vertices are adjacent unless
    # opposite; opposite pairs: (m01,m23), (m02,m13), (m03,m12))
    octa_splits = {
        0: [("m01", "m23", a, b) for a, b in
            (("m02", "m03"), ("m03", "m13"), ("m13", "m12"), ("m12", "m02"))],
        1: [("m02", "m13", a, b) for a, b in
            (("m01", "m03"), ("m03", "m23"), ("m23", "m12"), ("m12", "m01"))],
        2: [("m03", "m12", a, b) for a, b in
            (("m01", "m02"), ("m02", "m23"), ("m23", "m13"), ("m13", "m01"))],
    }
    conn_out, attr_out = [], []
    for ei, e in enumerate(m.elem_conn):
        v0, v1, v2, v3 = e

        def M(a, b):
            return nv + edges[_edge_key(e[a], e[b])]

        mid = {"m01": M(0, 1), "m02": M(0, 2), "m03": M(0, 3),
               "m12": M(1, 2), "m13": M(1, 3), "m23": M(2, 3)}
        children = [
            [v0, mid["m01"], mid["m02"], mid["m03"]],
            [mid["m01"], v1, mid["m12"], mid["m13"]],
            [mid["m02"], mid["m12"], v2, mid["m23"]],
            [mid["m03"], mid["m13"], mid["m23"], v3],
        ]
        dlen = [np.linalg.norm(new_verts[mid[a]] - new_verts[mid[b]])
                for a, b in (("m01", "m23"), ("m02", "m13"), ("m03", "m12"))]
        for names in octa_splits[int(np.argmin(dlen))]:
            t = [mid[nm] for nm in names]
            v = new_verts[t]
            if np.linalg.det(v[1:] - v[:1]) < 0:
                t[2], t[3] = t[3], t[2]
            children.append(t)
        conn_out += children
        attr_out += [m.elem_attr[ei]] * 8
    bdr_conn, bdr_attr = [], []
    for bi, f in enumerate(m.bdr_conn):
        v0, v1, v2 = f
        k01 = _edge_key(v0, v1)
        k12 = _edge_key(v1, v2)
        k20 = _edge_key(v2, v0)
        if k01 in edges and k12 in edges and k20 in edges:
            a, b, c = nv + edges[k01], nv + edges[k12], nv + edges[k20]
            bdr_conn += [[v0, a, c], [a, v1, b], [c, b, v2], [a, b, c]]
            bdr_attr += [m.bdr_attr[bi]] * 4
    return Mesh(3, TETRAHEDRON, new_verts, np.asarray(conn_out, np.int32),
                np.asarray(attr_out, np.int32), TRIANGLE,
                np.asarray(bdr_conn, np.int32), np.asarray(bdr_attr, np.int32))


def _refine_hex(m: Mesh) -> Mesh:
    edge_list = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    face_list = [
        (0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
        (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
    ]
    edges = _collect_edges(m.elem_conn, edge_list)
    faces = {}
    for e in m.elem_conn:
        for f in face_list:
            k = tuple(sorted(e[list(f)]))
            if k not in faces:
                faces[k] = len(faces)
    nv = m.num_vertices
    nE, nF, nC = len(edges), len(faces), m.num_elements
    new_verts = np.zeros((nv + nE + nF + nC, 3))
    new_verts[:nv] = m.vertices
    for (a, b), k in edges.items():
        new_verts[nv + k] = 0.5 * (m.vertices[a] + m.vertices[b])
    for fk, k in faces.items():
        new_verts[nv + nE + k] = m.vertices[list(fk)].mean(axis=0)
    conn_out, attr_out = [], []
    c0 = nv + nE + nF
    for ei, e in enumerate(m.elem_conn):
        new_verts[c0 + ei] = m.vertices[e].mean(axis=0)

        def E(a, b):
            return nv + edges[_edge_key(e[a], e[b])]

        def F(f):
            return nv + nE + faces[tuple(sorted(e[list(f)]))]

        # sub-vertex lattice ids (3x3x3) for the refined hex
        V = {}
        corners = {(0, 0, 0): e[0], (2, 0, 0): e[1], (2, 2, 0): e[2], (0, 2, 0): e[3],
                   (0, 0, 2): e[4], (2, 0, 2): e[5], (2, 2, 2): e[6], (0, 2, 2): e[7]}
        V.update(corners)
        em = {(1, 0, 0): E(0, 1), (2, 1, 0): E(1, 2), (1, 2, 0): E(2, 3), (0, 1, 0): E(3, 0),
              (1, 0, 2): E(4, 5), (2, 1, 2): E(5, 6), (1, 2, 2): E(6, 7), (0, 1, 2): E(7, 4),
              (0, 0, 1): E(0, 4), (2, 0, 1): E(1, 5), (2, 2, 1): E(2, 6), (0, 2, 1): E(3, 7)}
        V.update(em)
        fm = {(1, 1, 0): F(face_list[0]), (1, 1, 2): F(face_list[1]),
              (1, 0, 1): F(face_list[2]), (2, 1, 1): F(face_list[3]),
              (1, 2, 1): F(face_list[4]), (0, 1, 1): F(face_list[5])}
        V.update(fm)
        V[(1, 1, 1)] = c0 + ei
        for kk in range(2):
            for jj in range(2):
                for ii in range(2):
                    conn_out.append([
                        V[(ii, jj, kk)], V[(ii + 1, jj, kk)],
                        V[(ii + 1, jj + 1, kk)], V[(ii, jj + 1, kk)],
                        V[(ii, jj, kk + 1)], V[(ii + 1, jj, kk + 1)],
                        V[(ii + 1, jj + 1, kk + 1)], V[(ii, jj + 1, kk + 1)],
                    ])
                    attr_out.append(m.elem_attr[ei])
    bdr_conn, bdr_attr = [], []
    for bi, f in enumerate(m.bdr_conn):
        k = tuple(sorted(f))
        if k in faces:
            fc = nv + nE + faces[k]
            mids = [nv + edges[_edge_key(f[i], f[(i + 1) % 4])] for i in range(4)]
            v0, v1, v2, v3 = f
            m01, m12, m23, m30 = mids
            bdr_conn += [
                [v0, m01, fc, m30], [m01, v1, m12, fc],
                [fc, m12, v2, m23], [m30, fc, m23, v3],
            ]
            bdr_attr += [m.bdr_attr[bi]] * 4
    return Mesh(3, HEXAHEDRON, new_verts, np.asarray(conn_out, np.int32),
                np.asarray(attr_out, np.int32), QUAD,
                np.asarray(bdr_conn, np.int32), np.asarray(bdr_attr, np.int32))
