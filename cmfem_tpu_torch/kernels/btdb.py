"""The element-batched B^T D B apply: CUDA kernel wrapper + plain version.

``btdb_apply(BG, u_eT, Dflat)`` computes ``y_eT = BG^T (D (BG u_eT))`` per
element in the transposed layout of ``ops.partial.pack_qp_blocks_T``.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/btdb.cu`` (which
replaces ``cmfem_tpu/ops/partial.py::_pallas_btdb``, the TPU's element-tile
Pallas kernel); on a CPU tensor it runs ``btdb_plain``, the plain PyTorch
version (a port of ``_xla_btdb``).  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

# (m, nd, nq) the kernel is instantiated for: hexes (m = 4) and quads
# (m = 3) at orders 1-4 with q1 = p + 1 Gauss points per axis (hexes at
# order 4 through the kernel's tiled design)
KERNEL_SHAPES = ((4, 8, 8), (4, 27, 27), (4, 64, 64), (4, 125, 125),
                 (3, 4, 4), (3, 9, 9), (3, 16, 16), (3, 25, 25))
# shapes whose BG the kernel reads with its rows padded (zero columns) to
# this length: hexes at order 4, the kernel's tiled design
PADDED_ROWS = {(4, 125, 125): 128}
LIB_NAME = "cmfem_btdb"
SOURCES = ["btdb.cu"]

# Calls of the wrapper that launched the kernel.  Plain-version calls do
# not count.
launches = 0


def btdb_plain(BG, u_eT, Dflat):
    """Plain PyTorch version: U = BG u_eT; V_r = sum_s Dflat[r*m+s] U_s;
    y_eT = BG^T V.

    BG: (m*nq, nd) m-major [B; Gx; Gy(; Gz)]; u_eT: (nd, ne); Dflat:
    (m*m, nq, ne), m = 1 + dim (3 in 2D, 4 in 3D)."""
    mm, nq, _ = Dflat.shape
    m = int(round(mm ** 0.5))
    U = BG @ u_eT  # (m*nq, ne)
    rows = []
    for r in range(m):
        Vr = Dflat[r * m] * U[:nq]
        for s in range(1, m):
            Vr = Vr + Dflat[r * m + s] * U[s * nq:(s + 1) * nq]
        rows.append(Vr)
    return BG.T @ torch.cat(rows, dim=0)


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_btdb_apply_f32, lib.cmfem_btdb_apply_f64):
        # BG, ldb, u, D, y, m, nd, nq, ne, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_btdb_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_btdb_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernel's library now (it is built lazily)."""
    _lib()


def btdb_apply(BG, u_eT, Dflat):
    """y_eT (nd, ne): the CUDA kernel on a CUDA tensor, the plain version on
    CPU.  Raises on anything the kernel does not take (device, dtype, a
    shape outside KERNEL_SHAPES, a non-contiguous tensor)."""
    global launches
    if u_eT.device.type == "cpu":
        return btdb_plain(BG, u_eT, Dflat)
    if u_eT.device.type != "cuda":
        raise ValueError(f"btdb_apply: unsupported device {u_eT.device}")
    if u_eT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"btdb_apply: dtype {u_eT.dtype} not supported")
    if Dflat.dim() != 3 or BG.dim() != 2 or u_eT.dim() != 2:
        raise ValueError("btdb_apply: expected BG (m*nq, nd), u_eT (nd, ne),"
                         " Dflat (m*m, nq, ne)")
    mm, nq, ne = Dflat.shape
    nd = u_eT.shape[0]
    m = int(round(mm ** 0.5))
    if (m, nd, nq) not in KERNEL_SHAPES or m * m != mm:
        raise ValueError(f"btdb_apply: (m, nd, nq) = ({m}, {nd}, {nq}) is "
                         f"not one of {KERNEL_SHAPES}")
    for name, t, shape in (("BG", BG, (m * nq, nd)), ("u_eT", u_eT, (nd, ne)),
                           ("Dflat", Dflat, (mm, nq, ne))):
        if t.device != u_eT.device or t.dtype != u_eT.dtype:
            raise ValueError(f"btdb_apply: {name} is {t.dtype} on {t.device},"
                             f" u_eT is {u_eT.dtype} on {u_eT.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"btdb_apply: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"btdb_apply: {name} is not contiguous")
    lib = _lib()
    fn = (lib.cmfem_btdb_apply_f32 if u_eT.dtype == torch.float32
          else lib.cmfem_btdb_apply_f64)
    ldb = PADDED_ROWS.get((m, nd, nq), nd)
    if ldb != nd:
        BG = torch.nn.functional.pad(BG, (0, ldb - nd))
    y = torch.empty_like(u_eT)
    with torch.cuda.device(u_eT.device):
        stream = torch.cuda.current_stream(u_eT.device).cuda_stream
        err = fn(BG.data_ptr(), ldb, u_eT.data_ptr(), Dflat.data_ptr(),
                 y.data_ptr(), m, nd, nq, ne, stream)
    if err != 0:
        msg = lib.cmfem_btdb_error_string(err).decode()
        raise RuntimeError(f"btdb kernel launch failed: {msg} ({err})")
    launches += 1
    return y
