"""Packing of quadrature data + lattice DOF numbering for structured grids.

Port of the parts of ``cmfem_tpu/ops/partial.py`` that the sum-factorized
operator needs: ``pack_qp_blocks_T`` and ``StructuredGrid3D``.
``PAOperator``, ``StructuredPAOperator`` and the element-tile kernel
(``_pallas_btdb``) come with their CUDA port in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import SpaceOps, OperatorData
from ..core.reference_elements import get_reference_element, HEXAHEDRON


def pack_qp_blocks_T(ops: SpaceOps, data: OperatorData, dtype=torch.float32,
                     local_perm: np.ndarray | None = None):
    """Pack OperatorData into transposed layout.

    Returns (Dflat (m*m, nq, ne), BG (nq*m, ndof)) with BG stacked m-major
    ([B; Gx; Gy; Gz]) and columns optionally permuted to `local_perm`
    (lattice local ordering for the structured fast path)."""
    ne, nq = ops.gf.wdetJ.shape
    dim = ops.G.shape[-1]
    m = 1 + dim
    blocks = []
    for r in range(m):
        for s in range(m):
            if r == 0 and s == 0:
                v = data.d00
            elif r == 0:
                v = None if data.d01 is None else data.d01[..., s - 1]
            elif s == 0:
                v = None if data.d10 is None else data.d10[..., r - 1]
            else:
                v = None if data.d11 is None else data.d11[..., r - 1, s - 1]
            blocks.append(torch.zeros((ne, nq), dtype=dtype,
                                      device=ops.device)
                          if v is None else v.to(dtype))
    Dflat = torch.stack([b.T for b in blocks], dim=0)  # (m*m, nq, ne)
    BG = torch.cat([ops.B[None], torch.movedim(ops.G, 2, 0)], dim=0)
    BG = BG.reshape(m * nq, ops.B.shape[1])
    if local_perm is not None:
        BG = BG[:, torch.as_tensor(local_perm, device=BG.device)]
    return Dflat, BG.to(dtype)


class StructuredGrid3D:
    """Lattice DOF numbering for an (nx, ny, nz) hex grid at order p.

    DOF (i, j, k) -> k*NY*NX + j*NX + i with N* = n*p + 1; element
    (i, j, k) -> (k*ny + j)*nx + i (the ordering of
    ``make_cartesian_mesh_3d``).  Gather is (p+1)^3 strided slices;
    scatter is (p+1)^3 disjoint strided adds."""

    def __init__(self, nx: int, ny: int, nz: int, p: int):
        self.n = (nx, ny, nz)
        self.p = p
        self.NX, self.NY, self.NZ = nx * p + 1, ny * p + 1, nz * p + 1
        self.ndofs = self.NX * self.NY * self.NZ
        self.ne = nx * ny * nz
        self.offsets = [(a, b, c)
                        for c in range(p + 1)
                        for b in range(p + 1)
                        for a in range(p + 1)]
        # permutation: entity-ordered local dof -> lattice local index
        ref = get_reference_element(HEXAHEDRON, p)
        ti = ref._tensor_idx  # (nd, 3) (i, j, k)
        lattice_lin = (ti[:, 2] * (p + 1) + ti[:, 1]) * (p + 1) + ti[:, 0]
        # local_perm[lattice_idx] = entity_idx
        self.local_perm = np.argsort(lattice_lin)

    def _slices(self, a, b, c):
        p = self.p
        nx, ny, nz = self.n
        return (slice(c, c + p * (nz - 1) + 1, p),
                slice(b, b + p * (ny - 1) + 1, p),
                slice(a, a + p * (nx - 1) + 1, p))

    def gather(self, u):
        u3 = u.reshape(self.NZ, self.NY, self.NX)
        slabs = [u3[self._slices(a, b, c)].reshape(self.ne)
                 for (a, b, c) in self.offsets]
        return torch.stack(slabs, dim=0)  # (nd, ne) lattice-local order

    def scatter(self, y_eT):
        nx, ny, nz = self.n
        y3 = torch.zeros((self.NZ, self.NY, self.NX), dtype=y_eT.dtype,
                         device=y_eT.device)
        for idx, (a, b, c) in enumerate(self.offsets):
            y3[self._slices(a, b, c)] += y_eT[idx].reshape(nz, ny, nx)
        return y3.reshape(-1)

    def boundary_mask(self):
        """Boolean (ndofs,) numpy mask of lattice-boundary DOFs."""
        k, j, i = np.meshgrid(np.arange(self.NZ), np.arange(self.NY),
                              np.arange(self.NX), indexing="ij")
        on = ((i == 0) | (i == self.NX - 1) | (j == 0) | (j == self.NY - 1)
              | (k == 0) | (k == self.NZ - 1))
        return on.reshape(-1)

    def node_positions(self, sx=1.0, sy=1.0, sz=1.0):
        xs = np.linspace(0, sx, self.NX)
        ys = np.linspace(0, sy, self.NY)
        zs = np.linspace(0, sz, self.NZ)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
