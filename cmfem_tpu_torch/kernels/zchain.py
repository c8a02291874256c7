"""The z-chain of the sum-factorized apply: CUDA kernel wrapper + plain version.

``zchain_apply(T0, Tx, Ty, D, tab, Az, DAz, periodic)`` computes the three
z-stage outputs ``(U0, Ux, Uy)`` from the three x/y-contracted fields of
``SumFactoredOperator.bind_zchain``.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/sumfact_zchain.cu`` (which replaces
``cmfem_tpu/ops/sumfact.py::SumFactoredOperator._bind_pallas``, the TPU's
z-chain Pallas kernel); on a CPU tensor it runs ``zchain_plain``, the plain
PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

KERNEL_ORDERS = (1, 2, 3, 4)
LIB_NAME = "cmfem_zchain"
SOURCES = ["sumfact_zchain.cu"]
# threads the card holds at once (132 SMs x 2048): the wrapper splits each
# column's z range into chunks until about this many threads run
_RESIDENT_THREADS = 132 * 2048
# fewest z-elements per chunk: each chunk recomputes one element
_MIN_CHUNK = 8

# Calls of the wrapper that launched the kernel, and those of them that
# read the z-periodic Dz.  Plain-version calls do not count.
launches = 0
launches_periodic = 0


def zchain_plain(T0, Tx, Ty, D, Az, DAz, periodic: bool):
    """Plain PyTorch version: the four dense z-contractions, D pointwise,
    and the transposed contractions, as the TPU kernel's body computes them.

    T0, Tx, Ty: (NZ, KK); D: compressed planes (10, Kz, KK), or
    (10, q1, KK) z-periodic with ``periodic``; Az, DAz: (Kz, NZ).
    Returns (U0, Ux, Uy), each (NZ, KK), with U0 = Az^T W0 + DAz^T Wz."""
    V = [Az @ T0, Az @ Tx, Az @ Ty, DAz @ T0]
    if periodic:
        q1, KK = D.shape[1], D.shape[2]
        V = [v.reshape(-1, q1, KK) for v in V]
        D = D[:, None]
    # planes D00, D0x, D0y, D0z, Dxx, Dxy, Dxz, Dyy, Dyz, Dzz; d10 = 0
    W0 = D[0] * V[0] + D[1] * V[1] + D[2] * V[2] + D[3] * V[3]
    W1 = D[4] * V[1] + D[5] * V[2] + D[6] * V[3]
    W2 = D[5] * V[1] + D[7] * V[2] + D[8] * V[3]
    W3 = D[6] * V[1] + D[8] * V[2] + D[9] * V[3]
    W0, W1, W2, W3 = (w.reshape(Az.shape[0], -1) for w in (W0, W1, W2, W3))
    return Az.T @ W0 + DAz.T @ W3, Az.T @ W1, Az.T @ W2


def z_chunks(KK: int, nz: int) -> int:
    """How many chunks the kernel splits each column's nz z-elements into:
    enough for about one full wave of threads, none shorter than
    _MIN_CHUNK elements (and at least one)."""
    want = -(-_RESIDENT_THREADS // max(KK, 1))
    return max(1, min(want, nz // _MIN_CHUNK))


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_zchain_apply_f32, lib.cmfem_zchain_apply_f64):
        # T0, Tx, Ty, D, tab, U0, Ux, Uy, p, KK, nz, chunks, periodic, stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_zchain_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_zchain_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernel's library now (it is built lazily)."""
    _lib()


def zchain_apply(T0, Tx, Ty, D, tab, Az, DAz, periodic: bool):
    """(U0, Ux, Uy): the CUDA kernel on a CUDA tensor, the plain version on
    CPU.

    tab: (2, q1, p+1) = [B1; G1], the kernel's 1D tables; Az, DAz: the
    dense z matrices (the plain version's).  Raises on anything the kernel
    does not take (device, dtype, q1 != p + 1, p outside KERNEL_ORDERS, a
    shape that does not match, a non-contiguous tensor)."""
    global launches, launches_periodic
    if T0.device.type == "cpu":
        return zchain_plain(T0, Tx, Ty, D, Az, DAz, periodic)
    if T0.device.type != "cuda":
        raise ValueError(f"zchain_apply: unsupported device {T0.device}")
    if T0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"zchain_apply: dtype {T0.dtype} not supported")
    p = tab.shape[2] - 1
    q1 = tab.shape[1]
    if p not in KERNEL_ORDERS or q1 != p + 1 or tab.shape[0] != 2:
        raise ValueError(f"zchain_apply: tables {tuple(tab.shape)} need "
                         f"q1 = p + 1 with p in {KERNEL_ORDERS}")
    NZ, KK = T0.shape
    nz = (NZ - 1) // p
    if nz < 1 or nz * p + 1 != NZ:
        raise ValueError(f"zchain_apply: NZ = {NZ} is not nz*{p} + 1")
    d_shape = (10, q1 if periodic else nz * q1, KK)
    for name, t, shape in (("Tx", Tx, (NZ, KK)), ("Ty", Ty, (NZ, KK)),
                           ("T0", T0, (NZ, KK)), ("D", D, d_shape),
                           ("tab", tab, (2, q1, p + 1))):
        if t.device != T0.device or t.dtype != T0.dtype:
            raise ValueError(f"zchain_apply: {name} is {t.dtype} on "
                             f"{t.device}, T0 is {T0.dtype} on {T0.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"zchain_apply: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"zchain_apply: {name} is not contiguous")
    lib = _lib()
    fn = (lib.cmfem_zchain_apply_f32 if T0.dtype == torch.float32
          else lib.cmfem_zchain_apply_f64)
    U0, Ux, Uy = (torch.empty_like(T0) for _ in range(3))
    with torch.cuda.device(T0.device):
        stream = torch.cuda.current_stream(T0.device).cuda_stream
        err = fn(T0.data_ptr(), Tx.data_ptr(), Ty.data_ptr(), D.data_ptr(),
                 tab.data_ptr(), U0.data_ptr(), Ux.data_ptr(), Uy.data_ptr(),
                 p, KK, nz, z_chunks(KK, nz), int(periodic), stream)
    if err != 0:
        msg = lib.cmfem_zchain_error_string(err).decode()
        raise RuntimeError(f"zchain kernel launch failed: {msg} ({err})")
    launches += 1
    if periodic:
        launches_periodic += 1
    return U0, Ux, Uy
