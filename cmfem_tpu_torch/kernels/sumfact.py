"""The fused sum-factorized operator apply: CUDA kernel wrapper + plain version.

``sumfact_apply`` computes ``y = A u`` on a lattice-numbered vector for the
compressed (10-plane) D of ``ops.sumfact.SumFactoredOperator``.  On a CUDA
tensor it launches the hand-written lane kernel of ``csrc/sumfact_fused.cu``
(which replaces ``cmfem_tpu/ops/sumfact.py::_bind_fused_zfma`` on the
z-periodic Dz and ``_bind_fused`` on the full D, the TPU's fused Pallas
kernels) in one launch over all elements; on a CPU tensor it runs
``sumfact_chain``, the plain PyTorch version.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

KERNEL_ORDERS = (1, 2, 3, 4)
LIB_NAME = "cmfem_sumfact"
SOURCES = ["sumfact_fused.cu"]
WARPS_PER_BLOCK = 8

# Calls of ``sumfact_apply`` that launched the kernel, and those of them that
# read the full D rather than the z-periodic Dz.  Plain-version calls do not
# count.
launches = 0
launches_fulld = 0


def sumfact_chain(u, D, mats, periodic: bool):
    """Plain PyTorch version: y = A u through dense axis-matrix chains.

    u: (NZ*NY*NX,) lattice vector; D: compressed planes (10, Kz, Ky, Kx), or
    (10, q1, Ky, Kx) z-periodic with ``periodic``; mats: the axis matrices
    (Ax, DAx, Ay, DAy, Az, DAz), each (n*q1, n*p + 1)."""
    Ax, DAx, Ay, DAy, Az, DAz = mats
    Kz, Ky, Kx = Az.shape[0], Ay.shape[0], Ax.shape[0]
    u3 = u.reshape(Az.shape[1], Ay.shape[1], Ax.shape[1])

    def fwd(Mx, My, Mz):
        t = torch.einsum("ax,zyx->zya", Mx, u3)
        t = torch.einsum("by,zya->zba", My, t)
        return torch.einsum("cz,zba->cba", Mz, t)

    def bwd(w, Mx, My, Mz):
        t = torch.einsum("cz,cba->zba", Mz, w.reshape(Kz, Ky, Kx))
        t = torch.einsum("by,zba->zya", My, t)
        return torch.einsum("ax,zya->zyx", Mx, t)

    V = [fwd(Ax, Ay, Az), fwd(DAx, Ay, Az), fwd(Ax, DAy, Az),
         fwd(Ax, Ay, DAz)]
    if periodic:
        q1 = D.shape[1]
        V = [v.reshape(Kz // q1, q1, Ky, Kx) for v in V]
        D = D[:, None]
    # planes D00, D0x, D0y, D0z, Dxx, Dxy, Dxz, Dyy, Dyz, Dzz; d10 = 0
    W0 = D[0] * V[0] + D[1] * V[1] + D[2] * V[2] + D[3] * V[3]
    W1 = D[4] * V[1] + D[5] * V[2] + D[6] * V[3]
    W2 = D[5] * V[1] + D[7] * V[2] + D[8] * V[3]
    W3 = D[6] * V[1] + D[8] * V[2] + D[9] * V[3]
    y3 = (bwd(W0, Ax, Ay, Az) + bwd(W1, DAx, Ay, Az)
          + bwd(W2, Ax, DAy, Az) + bwd(W3, Ax, Ay, DAz))
    return y3.reshape(-1)


def launch_geometry(p: int, nx: int, ny: int, nz: int):
    """(elements per warp, warps per block, blocks) of the lane kernel.

    One lane per (element, qx, qy) column, so a warp holds 32 // (p+1)^2
    whole elements (8, 3, 2, 1 at p = 1..4).  The element of group g of
    warp w of block b is (b * warps + w) * per_warp + g, numbered x
    fastest; groups past nx*ny*nz idle.  The C entry refuses a geometry
    that does not cover the elements with no empty block."""
    if p not in KERNEL_ORDERS:
        raise ValueError(f"launch_geometry: p={p} not in {KERNEL_ORDERS}")
    per_warp = 32 // (p + 1) ** 2
    per_block = per_warp * WARPS_PER_BLOCK
    return per_warp, WARPS_PER_BLOCK, -(-nx * ny * nz // per_block)


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_sumfact_apply_f32, lib.cmfem_sumfact_apply_f64):
        # u, D, tab, y, p, nx, ny, nz, z_periodic, per_warp, warps, blocks,
        # stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernel's library now (it is built lazily)."""
    _lib()


def _checked_shape(name, u, D, tab, mats, periodic):
    """(p, nx, ny, nz) of a CUDA call; raises on anything the kernel does
    not take."""
    if u.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {u.device}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {u.dtype} not supported")
    Ax, _, Ay, _, Az, _ = mats
    p = tab.shape[2] - 1
    q1 = tab.shape[1]
    if p not in KERNEL_ORDERS or q1 != p + 1 or tab.shape[0] != 2:
        raise ValueError(f"{name}: tables {tuple(tab.shape)} need "
                         f"q1 = p + 1 with p in {KERNEL_ORDERS}")
    Kz, Ky, Kx = Az.shape[0], Ay.shape[0], Ax.shape[0]
    nx, ny, nz = Kx // q1, Ky // q1, Kz // q1
    ndofs = (nx * p + 1) * (ny * p + 1) * (nz * p + 1)
    d_shape = (10, q1 if periodic else Kz, Ky, Kx)
    for arg, t, shape in (("u", u, (ndofs,)), ("D", D, d_shape),
                          ("tab", tab, (2, q1, p + 1))):
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"u is {u.dtype} on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return p, nx, ny, nz


def _launch(entry, name, u, D, tab, *args):
    """Zero y, call the C entry on the current stream, raise on its error."""
    lib = _lib()
    fn = getattr(lib, entry + ("_f32" if u.dtype == torch.float32
                               else "_f64"))
    y = torch.zeros_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), D.data_ptr(), tab.data_ptr(), y.data_ptr(),
                 *args, stream)
    if err != 0:
        msg = lib.cmfem_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    return y


def sumfact_apply(u, D, tab, mats, periodic: bool):
    """y = A u: the CUDA lane kernel on a CUDA tensor, the plain version on
    CPU.

    tab: (2, q1, p+1) = [B1; G1], the 1D basis values and derivatives at
    the Gauss points (the kernel's tables); mats: the axis matrices (the
    plain version's).  Raises on anything the kernel does not take.  On
    CUDA the sums on DOFs shared by elements are taken with atomics, in an
    order that can change from run to run."""
    global launches, launches_fulld
    if u.device.type == "cpu":
        return sumfact_chain(u, D, mats, periodic)
    p, nx, ny, nz = _checked_shape("sumfact_apply", u, D, tab, mats,
                                   periodic)
    y = _launch("cmfem_sumfact_apply", "sumfact", u, D, tab, p, nx, ny, nz,
                int(periodic), *launch_geometry(p, nx, ny, nz))
    launches += 1
    if not periodic:
        launches_fulld += 1
    return y

