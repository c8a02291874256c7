"""ParaView output: VTU (unstructured grid) time series with PVD index.

Numpy copy of ``cmfem_tpu/io/vtu.py``.  Replaces the reference's ``ParaViewDataCollection`` (high-order binary VTK,
e.g. linear_convection_diffusion_2D.cpp:421-433).  High-order fields are
rendered exactly by subdividing each element into its nodal lattice of
linear sub-cells ("levels of detail" = polynomial order), which ParaView
renders identically to Lagrange high-order cells.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core.fespace import FESpace
from ..core.reference_elements import (
    TRIANGLE, QUAD, HEXAHEDRON, SEGMENT, TETRAHEDRON, get_reference_element,
    gauss_lobatto_nodes,
)

_VTK_TYPE = {TRIANGLE: 5, QUAD: 9, HEXAHEDRON: 12, SEGMENT: 3,
             TETRAHEDRON: 10}


def _lattice(geom: str, p: int):
    """Visualization lattice points + linear sub-cell connectivity."""
    x1 = gauss_lobatto_nodes(p)
    if geom == QUAD:
        pts = np.array([(x1[i], x1[j]) for j in range(p + 1) for i in range(p + 1)])
        cells = []
        for j in range(p):
            for i in range(p):
                n0 = j * (p + 1) + i
                cells.append([n0, n0 + 1, n0 + p + 2, n0 + p + 1])
        return pts, np.array(cells), QUAD
    if geom == HEXAHEDRON:
        pts = np.array([
            (x1[i], x1[j], x1[k])
            for k in range(p + 1) for j in range(p + 1) for i in range(p + 1)
        ])
        cells = []
        s = p + 1
        for k in range(p):
            for j in range(p):
                for i in range(p):
                    n0 = (k * s + j) * s + i
                    cells.append([
                        n0, n0 + 1, n0 + s + 1, n0 + s,
                        n0 + s * s, n0 + s * s + 1, n0 + s * s + s + 1, n0 + s * s + s,
                    ])
        return pts, np.array(cells), HEXAHEDRON
    if geom == TRIANGLE:
        # uniform barycentric lattice
        idx = {}
        pts = []
        for j in range(p + 1):
            for i in range(p + 1 - j):
                idx[(i, j)] = len(pts)
                pts.append((i / p, j / p))
        cells = []
        for j in range(p):
            for i in range(p - j):
                cells.append([idx[(i, j)], idx[(i + 1, j)], idx[(i, j + 1)]])
                if i + j < p - 1:
                    cells.append([idx[(i + 1, j)], idx[(i + 1, j + 1)], idx[(i, j + 1)]])
        return np.array(pts), np.array(cells), TRIANGLE
    if geom == TETRAHEDRON:
        # uniform barycentric lattice; each cell decomposes into an upward
        # tet, a 4-tet octahedron (diagonal A-F), and an inverted tet —
        # p^3 sub-tets total
        idx = {}
        pts = []
        for k in range(p + 1):
            for j in range(p + 1 - k):
                for i in range(p + 1 - k - j):
                    idx[(i, j, k)] = len(pts)
                    pts.append((i / p, j / p, k / p))
        cells = []
        for k in range(p):
            for j in range(p - k):
                for i in range(p - k - j):
                    s = i + j + k
                    V = idx[(i, j, k)]
                    A = idx[(i + 1, j, k)]
                    B = idx[(i, j + 1, k)]
                    C = idx[(i, j, k + 1)]
                    cells.append([V, A, B, C])
                    if s <= p - 2:
                        D = idx[(i + 1, j + 1, k)]
                        E = idx[(i + 1, j, k + 1)]
                        F = idx[(i, j + 1, k + 1)]
                        cells += [[A, F, B, D], [A, F, D, E],
                                  [A, F, E, C], [A, F, C, B]]
                        if s <= p - 3:
                            G = idx[(i + 1, j + 1, k + 1)]
                            cells.append([D, E, F, G])
        pts = np.array(pts)
        cells = np.array(cells)
        # consistent positive orientation (octahedron splits alternate)
        v = pts[cells]
        neg = np.linalg.det(v[:, 1:] - v[:, :1]) < 0
        cells[neg] = cells[neg][:, [0, 1, 3, 2]]
        return pts, cells, TETRAHEDRON
    raise NotImplementedError(geom)


class VTUCollection:
    """Time-series field output: writes <name>/<name>.pvd + step .vtu files."""

    def __init__(self, name: str, fes: FESpace, prefix_path: str = "ParaView",
                 high_order: bool = True):
        self.name = name
        self.fes = fes
        self.dir = os.path.join(prefix_path, name)
        os.makedirs(self.dir, exist_ok=True)
        self.steps = []  # (time, filename)
        p = fes.order if high_order else 1
        mesh = fes.mesh
        ref_pts, subcells, cell_geom = _lattice(mesh.geom, p)
        B, _ = fes.ref.eval(ref_pts)
        self._B = B  # (nlp, ndof)
        geo = get_reference_element(mesh.geom, 1)
        Bg, _ = geo.eval(ref_pts)
        self._Bgeo = Bg
        self._subcells = subcells
        self._vtk_type = _VTK_TYPE[cell_geom]
        self._nlp = len(ref_pts)

    def save(self, cycle: int, time: float, fields: dict, vertices=None):
        """fields: {name: dof_vector}; vertices overrides mesh coords
        (moving mesh output)."""
        mesh = self.fes.mesh
        verts = np.asarray(mesh.vertices if vertices is None else vertices)
        coords = verts[mesh.elem_conn]  # (ne, nc, dim)
        pts = np.einsum("qn,end->eqd", self._Bgeo, coords)  # (ne, nlp, dim)
        ne = mesh.num_elements
        npts = ne * self._nlp
        if mesh.dim == 2:
            pts3 = np.concatenate([pts, np.zeros((*pts.shape[:2], 1))], axis=-1)
        else:
            pts3 = pts
        pts3 = pts3.reshape(-1, 3)

        cells = (self._subcells[None, :, :] +
                 (np.arange(ne) * self._nlp)[:, None, None]).reshape(-1, self._subcells.shape[1])
        ncell = len(cells)

        fname = f"{self.name}_{cycle:06d}.vtu"
        path = os.path.join(self.dir, fname)
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
            f.write(f'<UnstructuredGrid><Piece NumberOfPoints="{npts}" NumberOfCells="{ncell}">\n')
            f.write('<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
            np.savetxt(f, pts3, fmt="%.16g")
            f.write('</DataArray></Points>\n')
            f.write('<Cells>\n<DataArray type="Int64" Name="connectivity" format="ascii">\n')
            np.savetxt(f, cells, fmt="%d")
            f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" format="ascii">\n')
            np.savetxt(f, np.arange(1, ncell + 1) * cells.shape[1], fmt="%d")
            f.write('</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
            np.savetxt(f, np.full(ncell, self._vtk_type), fmt="%d")
            f.write('</DataArray>\n</Cells>\n')
            f.write('<PointData>\n')
            for name, u in fields.items():
                u = np.asarray(u)
                if u.ndim == 2 and u.shape[0] == self.fes.nscalar:
                    # (nscalar, ncomp) explicit vector field
                    comps = [
                        np.einsum("qn,en->eq", self._B,
                                  u[:, c][self.fes.element_dofs]).reshape(-1)
                        for c in range(u.shape[1])
                    ]
                    while len(comps) < 3:
                        comps.append(np.zeros_like(comps[0]))
                    vals = np.stack(comps, axis=1)
                    f.write(f'<DataArray type="Float64" Name="{name}" '
                            f'NumberOfComponents="3" format="ascii">\n')
                    np.savetxt(f, vals, fmt="%.16g")
                elif u.ndim == 1 and len(u) == self.fes.nscalar:
                    vals = np.einsum("qn,en->eq", self._B,
                                     u[self.fes.element_dofs]).reshape(-1)
                    f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
                    np.savetxt(f, vals, fmt="%.16g")
                elif u.ndim == 1 and len(u) == self.fes.nscalar * self.fes.vdim:
                    ncomp = self.fes.vdim
                    comps = [
                        np.einsum("qn,en->eq", self._B,
                                  u[c * self.fes.nscalar:(c + 1) * self.fes.nscalar][self.fes.element_dofs]).reshape(-1)
                        for c in range(ncomp)
                    ]
                    while len(comps) < 3:
                        comps.append(np.zeros_like(comps[0]))
                    vals = np.stack(comps, axis=1)
                    f.write(f'<DataArray type="Float64" Name="{name}" NumberOfComponents="3" format="ascii">\n')
                    np.savetxt(f, vals, fmt="%.16g")
                elif u.ndim == 1 and len(u) == mesh.num_elements:
                    # L2(0) field: constant per element, replicated to
                    # lattice (2D arrays must not fall in here: np.repeat
                    # would flatten them into a wrong-length DataArray)
                    vals = np.repeat(u, self._nlp)
                    f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
                    np.savetxt(f, vals, fmt="%.16g")
                else:
                    raise ValueError(f"Field {name} has unexpected size {u.shape}")
                f.write('</DataArray>\n')
            f.write('</PointData>\n</Piece></UnstructuredGrid></VTKFile>\n')

        self.steps.append((time, fname))
        self._write_pvd()

    def _write_pvd(self):
        path = os.path.join(self.dir, f"{self.name}.pvd")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" version="0.1">\n<Collection>\n')
            for t, fn in self.steps:
                f.write(f'<DataSet timestep="{t}" part="0" file="{fn}"/>\n')
            f.write('</Collection>\n</VTKFile>\n')
