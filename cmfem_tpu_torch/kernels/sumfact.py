"""The fused sum-factorized operator apply: CUDA kernel wrapper + plain version.

``sumfact_apply`` computes ``y = A u`` on a lattice-numbered vector for the
compressed (10-plane) D of ``ops.sumfact.SumFactoredOperator``.  On a CUDA
tensor it launches the hand-written kernel of ``csrc/sumfact_fused.cu``
(which replaces ``cmfem_tpu/ops/sumfact.py::_bind_fused_zfma``, the TPU's
fused z-FMA Pallas kernel); on a CPU tensor it runs ``sumfact_chain``, the
plain PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

KERNEL_ORDERS = (1, 2, 3, 4)
LIB_NAME = "cmfem_sumfact"
SOURCES = ["sumfact_fused.cu"]

# Calls of the wrapper that launched the kernel (one call enqueues the
# kernel's 8 colour passes).  Plain-version calls do not count.
launches = 0


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


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_sumfact_apply_f32, lib.cmfem_sumfact_apply_f64):
        # u, D, tab, y, p, nx, ny, nz, z_periodic, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernel's library now (it is built lazily)."""
    _lib()


def sumfact_apply(u, D, tab, mats, periodic: bool):
    """y = A u: the CUDA kernel on a CUDA tensor, the plain version on CPU.

    tab: (2, q1, p+1) = [B1; G1], the 1D basis values and derivatives at
    the Gauss points (the kernel's tables); mats: the axis matrices (the
    plain version's).  Raises on anything the kernel does not take."""
    global launches
    if u.device.type == "cpu":
        return sumfact_chain(u, D, mats, periodic)
    if u.device.type != "cuda":
        raise ValueError(f"sumfact_apply: unsupported device {u.device}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sumfact_apply: dtype {u.dtype} not supported")
    Ax, _, Ay, _, Az, _ = mats
    p = tab.shape[2] - 1
    q1 = tab.shape[1]
    if p not in KERNEL_ORDERS or q1 != p + 1 or tab.shape[0] != 2:
        raise ValueError(f"sumfact_apply: tables {tuple(tab.shape)} need "
                         f"q1 = p + 1 with p in {KERNEL_ORDERS}")
    Kz, Ky, Kx = Az.shape[0], Ay.shape[0], Ax.shape[0]
    nx, ny, nz = Kx // q1, Ky // q1, Kz // q1
    ndofs = (nx * p + 1) * (ny * p + 1) * (nz * p + 1)
    d_shape = (10, q1 if periodic else Kz, Ky, Kx)
    for name, t, shape in (("u", u, (ndofs,)), ("D", D, d_shape),
                           ("tab", tab, (2, q1, p + 1))):
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"sumfact_apply: {name} is {t.dtype} on "
                             f"{t.device}, u is {u.dtype} on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sumfact_apply: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"sumfact_apply: {name} is not contiguous")
    lib = _lib()
    fn = (lib.cmfem_sumfact_apply_f32 if u.dtype == torch.float32
          else lib.cmfem_sumfact_apply_f64)
    y = torch.zeros_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), D.data_ptr(), tab.data_ptr(), y.data_ptr(),
                 p, nx, ny, nz, int(periodic), stream)
    if err != 0:
        msg = lib.cmfem_cuda_error_string(err).decode()
        raise RuntimeError(f"sumfact kernel launch failed: {msg} ({err})")
    launches += 1
    return y
