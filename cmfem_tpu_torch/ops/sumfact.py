"""Global sum-factorized operator apply for structured hex grids.

Port of ``cmfem_tpu/ops/sumfact.py``.  With a tensor-product grid,
interpolation of values and reference gradients to every quadrature point
is three axis-wise contractions of the 3D DOF lattice:

    V   = Az (x) Ay (x) Ax  u3          (values at every QP)
    Gx  = Az (x) Ay (x) DAx u3          (reference x-gradients), etc.

with block-banded 1D matrices A/DA of shape (n_el*q1, n_el*p + 1).  The QP
blocks D are permuted once into the same QP-lattice layout, the 4x4 block
action is pointwise, and the transposed chains assemble y3 directly.

Two apply paths, both on lattice-numbered vectors:

- the plain PyTorch chains (``bind()``, ``_bind_periodic``): dense axis
  matrices and einsum, any device;
- the hand-written CUDA kernel (``bind_kernel``, csrc/sumfact_fused.cu),
  which replaces the TPU's fused z-FMA Pallas kernel
  (``cmfem_tpu/ops/sumfact.py::_bind_fused_zfma``).  ``best_bind`` picks it
  for compressed D on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import SpaceOps, OperatorData
from .partial import pack_qp_blocks_T
from ..core.quadrature import _gauss_1d
from ..core.reference_elements import gauss_lobatto_nodes, _lagrange_1d
from ..kernels.sumfact import KERNEL_ORDERS, sumfact_apply, sumfact_chain

# upper-triangular (r, s) grad-grad pairs of the compressed packing; plane
# order D00, D0x, D0y, D0z, Dxx, Dxy, Dxz, Dyy, Dyz, Dzz
_PAIRS = [(1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (3, 3)]


def _lagrange_tab_1d(p: int, q1: int):
    """1D basis values/derivatives at q1 Gauss points: (q1, p+1) each."""
    nodes = gauss_lobatto_nodes(p)
    x, w = _gauss_1d(q1)
    B, G = _lagrange_1d(nodes, x)
    return B, G, w


def _axis_matrices(n_el: int, p: int, q1: int):
    """Block-banded (n_el*q1, n_el*p+1) interpolation + derivative matrices."""
    B, G, _ = _lagrange_tab_1d(p, q1)
    N = n_el * p + 1
    A = np.zeros((n_el * q1, N))
    DA = np.zeros((n_el * q1, N))
    for e in range(n_el):
        A[e * q1:(e + 1) * q1, e * p:e * p + p + 1] = B
        DA[e * q1:(e + 1) * q1, e * p:e * p + p + 1] = G
    return A, DA


def _tensor(a, device, dtype):
    """A tensor on ``device`` in ``dtype`` from a tensor or an array (numpy
    or jax, copied: arrays taken out of jax are read-only)."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def _fwd(u3, Mx, My, Mz):
    # contract each axis in turn: (NZ,NY,NX) -> (Kz,Ky,Kx)
    t = torch.einsum("ax,zyx->zya", Mx, u3)
    t = torch.einsum("by,zya->zba", My, t)
    return torch.einsum("cz,zba->cba", Mz, t)


def _bwd(w3, Mx, My, Mz):
    t = torch.einsum("cz,cba->zba", Mz, w3)
    t = torch.einsum("by,zba->zya", My, t)
    return torch.einsum("ax,zya->zyx", Mx, t)


class SumFactoredOperator:
    """Matrix-free structured-grid operator with zero gather/scatter.

    Built from a SpaceOps/OperatorData pair on a ``make_cartesian_mesh_3d``
    mesh; acts on lattice-numbered DOF vectors (same numbering as
    StructuredGrid3D).  D lives on ``device`` in ``dtype``."""

    def __init__(self, ops: SpaceOps, data: OperatorData, nx, ny, nz,
                 order: int, *, device, dtype=torch.float32):
        device = torch.device(device)
        q1 = round(len(ops.quad.weights) ** (1 / 3))
        if q1**3 != len(ops.quad.weights):
            raise ValueError("SumFactoredOperator expects a tensor "
                             "quadrature rule")
        # The compression flags are decided on float64 data, before the
        # cast to ``dtype``: d11 is symmetric by construction, and a test
        # on rounded data could only lose that.
        Dflat, _ = pack_qp_blocks_T(ops, data, torch.float64)
        Dflat = Dflat.to(device)
        mm, nq, ne = Dflat.shape
        m = int(round(np.sqrt(mm)))
        sym = all(
            bool((Dflat[r * m + s] - Dflat[s * m + r]).abs()
                 .le(1e-12 * Dflat[s * m + r].abs()).all())
            for r in range(1, m) for s in range(r + 1, m))
        no_d10 = all(not bool(Dflat[r * m].any()) for r in range(1, m))
        compressed = sym and no_d10
        if compressed:
            Dflat = torch.stack([Dflat[0]] + [Dflat[s] for s in range(1, m)]
                                + [Dflat[r * m + s] for r, s in _PAIRS])
            mm = Dflat.shape[0]
        # (mm, q: qz,qy,qx, e: k,j,i) -> QP lattice (mm, Kz, Ky, Kx), where
        # lattice point (k*q1+qz, j*q1+qy, i*q1+qx) holds element (i,j,k)'s
        # quadrature point (qx,qy,qz)
        D = (Dflat.reshape(mm, q1, q1, q1, nz, ny, nx)
             .permute(0, 4, 1, 5, 2, 6, 3)
             .reshape(mm, nz * q1, ny * q1, nx * q1).to(dtype))
        del Dflat
        # Element periodicity, exactly as the JAX package tests it: on the
        # cast D, with a floor of eps(dtype) * max(n) * max|D| (O(1)
        # coordinates differenced into O(1/n) elements lose a factor
        # max(n)), capped at 1e-5 * max|D|.
        tol = (torch.tensor(min(4 * torch.finfo(dtype).eps * max(nx, ny, nz),
                                1e-5), dtype=dtype, device=device)
               * D.abs().max())
        D7 = D.reshape(mm, nz, q1, ny, q1, nx, q1)
        Dsmall = D7.double().mean(dim=(1, 3, 5), keepdim=True).to(dtype)
        periodic = bool((D7 - Dsmall).abs().max() <= tol)
        D5 = D.reshape(mm, nz, q1, ny * q1, nx * q1)
        Dz = D5.double().mean(dim=1).to(dtype)
        z_periodic = bool((D5 - Dz[:, None]).abs().max() <= tol)
        self._init_arrays(D, Dz if z_periodic else None, (nx, ny, nz), order,
                          q1, compressed=compressed, periodic=periodic,
                          z_periodic=z_periodic, device=device, dtype=dtype)

    @classmethod
    def from_arrays(cls, D, Dz, axes, n, order: int, *, compressed: bool,
                    periodic: bool, z_periodic: bool, device,
                    dtype=torch.float32):
        """An operator from D (mm, Kz, Ky, Kx) and Dz (mm, q1, Ky, Kx) in the
        lattice layout, the axis matrices (Ax, DAx, Ay, DAy, Az, DAz) and
        the flags: numpy arrays or tensors, e.g. ``np.asarray(jax_op.D)``."""
        op = cls.__new__(cls)
        D = _tensor(D, device, dtype)
        Dz = None if Dz is None else _tensor(Dz, device, dtype)
        op._init_arrays(D, Dz, tuple(n), order, D.shape[3] // n[0],
                        compressed=compressed, periodic=periodic,
                        z_periodic=z_periodic, device=torch.device(device),
                        dtype=dtype, axes=axes)
        return op

    def _init_arrays(self, D, Dz, n, order, q1, *, compressed, periodic,
                     z_periodic, device, dtype, axes=None):
        nx, ny, nz = n
        p = order
        self.device, self.dtype = device, dtype
        self.n, self.p, self.q1 = n, p, q1
        self.NX, self.NY, self.NZ = nx * p + 1, ny * p + 1, nz * p + 1
        self.ndofs = self.NX * self.NY * self.NZ
        self.Kz, self.Ky, self.Kx = nz * q1, ny * q1, nx * q1
        self.m = 4
        self.compressed = bool(compressed)
        self.periodic = bool(periodic)
        self.z_periodic = bool(z_periodic)
        self.D = D.contiguous()
        self.Dz = None if Dz is None else Dz.contiguous()
        if axes is None:
            axes = [M for k in n for M in _axis_matrices(k, p, q1)]
        (self.Ax, self.DAx, self.Ay, self.DAy, self.Az,
         self.DAz) = [_tensor(M, device, dtype) for M in axes]
        B1, G1, _ = _lagrange_tab_1d(p, q1)
        # the kernel's 1D tables: (2, q1, p+1) = [B1; G1]
        self.tab = _tensor(np.stack([B1, G1]), device, dtype)

    @property
    def _mats(self):
        return (self.Ax, self.DAx, self.Ay, self.DAy, self.Az, self.DAz)

    def bind(self, use_periodic: bool = False):
        """(fn(u, D) -> y, D): the plain PyTorch chain.

        use_periodic replaces the full lattice D with the z-periodic
        (mm, q1, Ky, Kx) pattern (requires ``self.z_periodic``)."""
        if use_periodic:
            if not (self.z_periodic and self.compressed):
                raise ValueError(
                    "periodic sumfact path requires z-periodic compressed "
                    "D (uniform z-extrusion, z-uniform coefficients)")
            return self._bind_periodic(), self.Dz
        mats, dtype = self._mats, self.dtype
        NX, NY, NZ = self.NX, self.NY, self.NZ
        if self.compressed:
            return (lambda u, D: sumfact_chain(u.to(dtype), D, mats, False),
                    self.D)
        Ax, DAx, Ay, DAy, Az, DAz = mats
        m = self.m

        def fn(u, D):
            u3 = u.to(dtype).reshape(NZ, NY, NX)
            V = [_fwd(u3, Ax, Ay, Az), _fwd(u3, DAx, Ay, Az),
                 _fwd(u3, Ax, DAy, Az), _fwd(u3, Ax, Ay, DAz)]
            W = []
            for r in range(m):
                acc = D[r * m] * V[0]
                for s in range(1, m):
                    acc = acc + D[r * m + s] * V[s]
                W.append(acc)
            y3 = (_bwd(W[0], Ax, Ay, Az) + _bwd(W[1], DAx, Ay, Az)
                  + _bwd(W[2], Ax, DAy, Az) + _bwd(W[3], Ax, Ay, DAz))
            return y3.reshape(-1)

        return fn, self.D

    def _bind_periodic(self):
        """Plain chain with the z-tiled D pattern: the quadrature fields are
        viewed as (nz, q1, Ky, Kx) so the (q1, Ky, Kx) D planes broadcast
        along the leading z axis."""
        mats, dtype = self._mats, self.dtype
        return lambda u, D: sumfact_chain(u.to(dtype), D, mats, True)

    def bind_kernel(self, use_periodic: bool = False):
        """(fn(u, D) -> y, D): the CUDA kernel (plain chain for CPU tensors).

        Requires compressed D and q1 = p + 1 with p in KERNEL_ORDERS; with
        use_periodic the kernel reads the z-periodic Dz, else the full D."""
        if not self.kernel_eligible:
            raise ValueError(
                "the sumfact kernel needs compressed D and q1 = p + 1 with "
                f"p in {KERNEL_ORDERS} (got compressed={self.compressed}, "
                f"p={self.p}, q1={self.q1})")
        if use_periodic and not self.z_periodic:
            raise ValueError("periodic kernel path requires z-periodic D")
        tab, mats, dtype = self.tab, self._mats, self.dtype

        def fn(u, D):
            return sumfact_apply(u.to(dtype), D, tab, mats, use_periodic)

        return fn, (self.Dz if use_periodic else self.D)

    @property
    def kernel_eligible(self) -> bool:
        return (self.compressed and self.q1 == self.p + 1
                and self.p in KERNEL_ORDERS)

    def best_bind(self):
        """(fn, D_arg, path): the kernel for compressed D on a CUDA device
        (z-periodic Dz when the operator is z-periodic, else full D), the
        plain generic chain otherwise.  ``path`` names what was bound."""
        if self.D.device.type == "cuda" and self.kernel_eligible:
            if self.z_periodic:
                return (*self.bind_kernel(use_periodic=True),
                        "cuda-sumfact-zperiodic")
            return (*self.bind_kernel(), "cuda-sumfact-fullD")
        return (*self.bind(), "plain-chain")

    def __call__(self, u):
        fn, D = self.bind()
        return fn(u, D)
