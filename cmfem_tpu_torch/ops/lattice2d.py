"""Window-slicing gather/scatter for tensor-product 2D dof lattices.

Port of ``cmfem_tpu/ops/lattice2d.py``.  On a tensor-product strip mesh the
element dof pattern is a fixed lattice stencil, so

- gather  = ``nd`` strided window slices of the (NY, NX) dof lattice, and
- scatter = ``nd`` shifted overlap-adds into strided windows (``F.pad``
  plus an in-place add on a strided view).

The JAX package takes this path because per-element gathers and
segment-sum scatters scalarize on the TPU.  On the GPU a gather and an
``index_add_`` do not; the block solvers use the lattice for their stencil
(DIA) layout, and the ablation residual takes it only on request
(``lattice_residual: true``), so that the card can say which is faster.

The plan requires mesh elements to be ordered row-major over the cell
lattice (true for ``make_cartesian_mesh_2d``; GMSH strips can be
renumbered with ``reorder_mesh_elements``); it raises otherwise, and
callers fall back to the generic gather/scatter path.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F


class StripLatticeOps:
    """Gather/scatter over a (NY, NX) tensor-product dof lattice.

    Parameters
    ----------
    element_dofs : (ne, nd) scalar-space element dof map.
    n            : scalar dof count.
    lat          : (NY, NX) dof-id lattice (``strip_dof_lattice``).
    device       : where the permutations live.

    Raises ValueError when the elements are not a uniform row-major cell
    lattice over ``lat`` (caller should fall back to the generic path).
    """

    def __init__(self, element_dofs, n, lat, device="cpu"):
        ed = np.asarray(element_dofs, dtype=np.int64)
        lat = np.asarray(lat, dtype=np.int64)
        NY, NX = lat.shape
        ne, nd = ed.shape
        if NY * NX != int(n):
            raise ValueError("lattice must enumerate every scalar dof")
        perm = np.empty(int(n), np.int64)
        perm[lat.reshape(-1)] = np.arange(int(n))
        ly, lx = perm[ed] // NX, perm[ed] % NX      # (ne, nd)
        ey, ex = ly.min(axis=1), lx.min(axis=1)
        oy, ox = ly - ey[:, None], lx - ex[:, None]
        if not ((oy == oy[0]).all() and (ox == ox[0]).all()):
            raise ValueError("elements do not share one lattice dof stencil")
        py, px = int(oy[0].max()), int(ox[0].max())
        if py == 0 or px == 0 or (NY - 1) % py or (NX - 1) % px:
            raise ValueError("element stencil does not tile the lattice")
        nyc, nxc = (NY - 1) // py, (NX - 1) // px
        if ne != nyc * nxc:
            raise ValueError("element count does not match the cell lattice")
        if ey.max() + py != NY - 1 or ex.max() + px != NX - 1:
            raise ValueError("element cells do not cover the lattice")
        cell = (ey // py) * nxc + (ex // px)
        if not (cell == np.arange(ne)).all():
            raise ValueError(
                "mesh elements are not row-major over the cell lattice; "
                "renumber elements (argsort by cell) to enable this path")
        self.NY, self.NX = NY, NX
        self.nyc, self.nxc = nyc, nxc
        self.py, self.px = py, px
        self.ne, self.nd = ne, nd
        self.n = int(n)
        self.offs = [(int(a), int(b)) for a, b in zip(oy[0], ox[0])]
        self.latflat = torch.as_tensor(lat.reshape(-1), device=device)
        self.dofperm = torch.as_tensor(perm, device=device)

    # -- lattice <-> dof order ----------------------------------------------

    def to_lat(self, u):
        """dof-ordered (n,) -> (NY, NX) lattice field (one gather)."""
        return u[self.latflat].reshape(self.NY, self.NX)

    def from_lat(self, ul):
        """(NY, NX) lattice field -> dof-ordered (n,) (one gather)."""
        return ul.reshape(-1)[self.dofperm]

    # -- element-window access ------------------------------------------------

    def windows(self, ul):
        """(NY, NX) -> list of nd (nyc, nxc) element-corner windows: entry
        ``a`` holds local dof ``a`` of every element, row-major cells."""
        return [ul[oy::self.py, ox::self.px][:self.nyc, :self.nxc]
                for (oy, ox) in self.offs]

    def gather_elem(self, ul):
        """(NY, NX) lattice field -> (ne, nd) element dof values without an
        index gather (stack of strided windows)."""
        return torch.stack([w.reshape(-1) for w in self.windows(ul)], dim=1)

    def add_window(self, dst, vals, a):
        """dst (..., NY, NX) += vals (..., nyc, nxc) scattered to local-dof
        window ``a`` (the shared overlap-add of scatter() and the block
        solver's stencil assembly); in place, returns dst."""
        oy, ox = self.offs[a]
        py, px = self.py, self.px
        pad_y = (self.NY - oy + py - 1) // py - self.nyc
        pad_x = (self.NX - ox + px - 1) // px - self.nxc
        dst[..., oy::py, ox::px] += F.pad(vals, (0, pad_x, 0, pad_y))
        return dst

    def scatter(self, y_e):
        """(ne, nd) element contributions -> dof-ordered (n,) via nd
        shifted overlap-adds."""
        ycells = y_e.reshape(self.nyc, self.nxc, self.nd)
        yl = torch.zeros((self.NY, self.NX), dtype=y_e.dtype,
                         device=y_e.device)
        for a in range(self.nd):
            self.add_window(yl, ycells[:, :, a], a)
        return self.from_lat(yl)


def cluster_x_columns(vals, tol_factor=1e-8):
    """Tolerance-walk clustering of 1D coordinates into columns: returns
    (col_index_per_val, ncols).  The single home of the GMSH float-jitter
    tolerance, shared by ``solvers.blocksolve.strip_dof_lattice`` and
    ``strip_element_order``."""
    vs = np.unique(vals)
    span = max(float(vs[-1] - vs[0]), 1e-30)
    tol = tol_factor * span
    reps = [float(vs[0])]
    for v in vs[1:]:
        if v - reps[-1] > tol:
            reps.append(float(v))
    edges = 0.5 * (np.asarray(reps[1:]) + np.asarray(reps[:-1]))
    return np.searchsorted(edges, vals), len(reps)


def strip_element_order(mesh):
    """Row-major (y-outer, x-inner) element permutation for a 2D
    tensor-product strip mesh, from tolerance-clustered element centroids
    (same clustering as ``solvers.blocksolve.strip_dof_lattice``).
    Returns ``order`` with ``elem_conn[order]`` row-major over cells, or
    raises ValueError when the centroids are not a full tensor grid."""
    cent = mesh.vertices[mesh.elem_conn].mean(axis=1)
    ne = len(cent)

    # x columns by tolerance walk; rows by per-column y sort — strip meshes
    # share x columns exactly but may carry per-column y jitter, so y
    # cannot be clustered globally
    cx, nxc = cluster_x_columns(cent[:, 0])
    if ne % nxc:
        raise ValueError("element centroids do not form a column lattice")
    nyc = ne // nxc
    cell = np.empty(ne, np.int64)
    for c in range(nxc):
        ids = np.nonzero(cx == c)[0]
        if len(ids) != nyc:
            raise ValueError("unequal column heights in element lattice")
        cell[ids[np.argsort(cent[ids, 1], kind="stable")]] = \
            np.arange(nyc) * nxc + c
    return np.argsort(cell, kind="stable")


def reorder_mesh_elements(mesh, order):
    """A copy of ``mesh`` with volume elements permuted by ``order``
    (boundary faces and vertices untouched; per-element state arrays in
    callers must be built after the reorder)."""
    return replace(
        mesh,
        elem_conn=np.ascontiguousarray(mesh.elem_conn[order]),
        elem_attr=np.ascontiguousarray(mesh.elem_attr[order]),
    )
