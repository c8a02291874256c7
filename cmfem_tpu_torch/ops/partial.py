"""Matrix-free partial assembly in the transposed layout.

Port of ``cmfem_tpu/ops/partial.py``: ``pack_qp_blocks_T``,
``StructuredGrid3D``, and the two element-batched operators that apply
B^T D B per element, ``PAOperator`` (any mesh: ``u[eldofs]`` gather and
``index_add_`` scatter) and ``StructuredPAOperator`` (lattice gather and
scatter of ``StructuredGrid3D``).  Their element stage is decided once, at
construction (``element_path``): on CUDA tensors it is
``kernels.btdb.btdb_apply``, the hand-written CUDA kernel that replaces the
TPU's ``_pallas_btdb`` (every element shape of the JAX package's spaces at
orders 1-4, ``kernels.btdb.KERNEL_SHAPES``), and any other shape is refused
there and then; ``btdb_plain`` (a port of ``_xla_btdb``, which takes any
mesh) runs on CPU tensors and where the caller asks for it with
``use_kernel=False``.  The gather and scatter stay torch ops, as the JAX
package keeps them outside its Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import SpaceOps, OperatorData
from ..core.reference_elements import get_reference_element, HEXAHEDRON
from ..kernels.btdb import btdb_apply, btdb_plain, pack_bg, require_kernel


def _tensor(a, device, dtype):
    """A tensor on ``device`` in ``dtype`` from a tensor or an array (numpy
    or jax, copied: arrays taken out of jax are read-only)."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def element_path(m: int, nd: int, nq: int, device, dtype,
                 use_kernel: bool = True) -> str:
    """The element stage of an operator with ``nd`` DOFs and ``nq`` points
    per element in ``m - 1`` dimensions: ``"plain-btdb"`` (``btdb_plain``,
    any element) on a CPU device or with ``use_kernel=False``, else
    ``"cuda-btdb"`` (the B1 kernel).  Raises as ``btdb_apply`` would where
    the kernel does not take the device, the dtype or (m, nd, nq): the plain
    version never stands in for the kernel unasked."""
    if not use_kernel or torch.device(device).type == "cpu":
        return "plain-btdb"
    require_kernel(device, dtype, m, nd, nq)
    return "cuda-btdb"


class _ElementBatched:
    """What PAOperator and StructuredPAOperator share: the packed arrays and
    the element stage, fixed at construction and named by ``path``."""

    def _init_element_stage(self, Dflat, BG, use_kernel):
        self.dtype, self.device = Dflat.dtype, Dflat.device
        self.m = int(round(Dflat.shape[0] ** 0.5))
        self.nq = Dflat.shape[1]
        self._path = element_path(self.m, BG.shape[1], self.nq, self.device,
                                  self.dtype, use_kernel)
        self.Dflat = Dflat.contiguous()
        self.BG = BG.contiguous()
        # the kernel's layout of BG, once and not per apply
        self.BG_stream = pack_bg(self.BG, self.m, self.nq) \
            if self._path == "cuda-btdb" else None

    @property
    def path(self) -> str:
        """``"cuda-btdb"`` or ``"plain-btdb"`` (see ``element_path``)."""
        return self._path

    def _element_stage(self):
        """fn(u_eT, Dflat) -> y_eT: the B1 kernel wrapper with the operator's
        BG and its packed stream, or the plain version."""
        BG, packed = self.BG, self.BG_stream
        if self._path == "cuda-btdb":
            return lambda u_eT, Dflat: btdb_apply(BG, u_eT, Dflat, packed)
        return lambda u_eT, Dflat: btdb_plain(BG, u_eT, Dflat)


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


class PAOperator(_ElementBatched):
    """Matrix-free operator for an arbitrary (unstructured) mesh.

    Gather/scatter via ``u[eldofs]`` / ``index_add_``; the element stage is
    named by ``path``: ``"cuda-btdb"`` (the B1 kernel, on CUDA tensors:
    triangles, quads, tets and hexes at orders 1-4 under the rules of
    ``kernels.btdb.KERNEL_SHAPES``, and a ValueError at construction for any
    other shape) or ``"plain-btdb"`` (CPU tensors,
    or ``use_kernel=False``).  Acts on entity-numbered vectors."""

    def __init__(self, ops: SpaceOps, data: OperatorData, *,
                 dtype=torch.float32, use_kernel: bool = True):
        Dflat, BG = pack_qp_blocks_T(ops, data, dtype)
        self._init_arrays(Dflat, BG, ops.eldofs, ops.fes.nscalar, use_kernel)

    @classmethod
    def from_arrays(cls, Dflat, BG, eldofs, nscalar: int, *, device,
                    dtype=torch.float32, use_kernel: bool = True):
        """An operator from ``pack_qp_blocks_T``'s output of either package,
        Dflat (m*m, nq, ne) and BG (m*nq, nd), the element DOFs (ne, nd)
        and the number of DOFs: numpy arrays or tensors."""
        op = cls.__new__(cls)
        op._init_arrays(_tensor(Dflat, device, dtype),
                        _tensor(BG, device, dtype),
                        _tensor(eldofs, device, torch.int64), nscalar,
                        use_kernel)
        return op

    def _init_arrays(self, Dflat, BG, eldofs, nscalar, use_kernel):
        self._init_element_stage(Dflat, BG, use_kernel)
        self.nscalar = int(nscalar)
        # element DOFs in the transposed layout (nd, ne), so that u[eldofs_T]
        # is u_eT and index_add_ reads it flat, with no copy per apply
        self.eldofs_T = eldofs.to(device=self.device,
                                  dtype=torch.int64).T.contiguous()

    def bind(self):
        """(fn(u, Dflat, eldofs_T) -> y, Dflat, eldofs_T): the apply, with
        the big arrays passed as arguments (the JAX package's contract; the
        element DOFs travel transposed, (nd, ne))."""
        nscalar, dtype = self.nscalar, self.dtype
        apply_ = self._element_stage()

        def fn(u, Dflat, eldofs_T):
            y_eT = apply_(u.to(dtype)[eldofs_T], Dflat)
            y = torch.zeros(nscalar, dtype=dtype, device=y_eT.device)
            return y.index_add_(0, eldofs_T.view(-1), y_eT.view(-1))

        return fn, self.Dflat, self.eldofs_T

    def __call__(self, u):
        fn, Dflat, eldofs_T = self.bind()
        return fn(u, Dflat, eldofs_T)


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


class StructuredPAOperator(_ElementBatched):
    """Lattice gather/scatter + the element-batched B1 apply.

    Built from a SpaceOps on a ``make_cartesian_mesh_3d`` mesh; the
    operator acts on lattice-numbered DOF vectors (use ``grid`` helpers for
    BCs / interpolation).  ``path`` and ``use_kernel`` as for PAOperator."""

    def __init__(self, ops: SpaceOps, data: OperatorData,
                 grid: StructuredGrid3D, *, dtype=torch.float32,
                 use_kernel: bool = True):
        Dflat, BG = pack_qp_blocks_T(ops, data, dtype,
                                     local_perm=grid.local_perm)
        self._init_arrays(Dflat, BG, grid, use_kernel)

    @classmethod
    def from_arrays(cls, Dflat, BG, grid: StructuredGrid3D, *, device,
                    dtype=torch.float32, use_kernel: bool = True):
        """An operator from ``pack_qp_blocks_T``'s output of either package
        (BG's columns in the lattice-local order of ``grid.local_perm``):
        numpy arrays or tensors."""
        op = cls.__new__(cls)
        op._init_arrays(_tensor(Dflat, device, dtype),
                        _tensor(BG, device, dtype), grid, use_kernel)
        return op

    def _init_arrays(self, Dflat, BG, grid, use_kernel):
        self.grid = grid
        self._init_element_stage(Dflat, BG, use_kernel)

    def bind(self):
        """(fn(u, Dflat) -> y, Dflat); see PAOperator.bind."""
        grid, dtype = self.grid, self.dtype
        apply_ = self._element_stage()

        def fn(u, Dflat):
            return grid.scatter(apply_(grid.gather(u.to(dtype)), Dflat))

        return fn, self.Dflat

    def __call__(self, u):
        fn, Dflat = self.bind()
        return fn(u, Dflat)
