"""The y-line factorization and solve of the line multigrid: CUDA kernel
wrappers + plain versions.

``line_factor(SS)`` factors every x-column's block-tridiagonal y-line system
of the canonical (3, 3, NY, NX, 2, 2) stencil by block-QR elimination and
returns (R, C1, E, Q, Qf, Rf); ``line_solve(fac, r)`` solves the columns'
systems for r (NY, NX, 2).  On CUDA tensors each launches a hand-written
kernel of ``csrc/linemg.cu``: the factorization one chain thread per
column, fed and drained by a second warp through shared-memory rings; the
solve one cluster of blocks per column (``solve_geometry``), its forward
sweep a parallel scan and its backward sweep one walk over the rows staged
in shared memory (past 4,097 rows in float64, some in device memory).  On
CPU tensors they run ``line_factor_plain`` and
``line_solve_plain``, ports of the JAX package's
``cmfem_tpu/solvers/linemg.py::line_factor`` and ``line_solve``.  No TPU
kernel stands behind them (the JAX package leaves the scans to XLA): the
kernels exist because the plain versions' row loops are launch-bound on
the card.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import F64_FLOP_PER_S, bound, graph_ms, median_ms
from .build import load_library

LIB_NAME = "cmfem_linemg"
SOURCES = ["linemg.cu"]

# Calls of the wrappers that launched a kernel.  Plain-version calls do not
# count.
launches_factor = 0
launches_solve = 0

# line_solve's launch geometry, as csrc/linemg.cu::solve_geometry has it
SOLVE_THREADS = 128      # a block
CARD_SMS = 132           # the H100 SXM
MAX_CLUSTER = 8          # the portable cluster size


def solve_geometry(NY, NX, itemsize):
    """(threads, cluster, seg, run) of ``line_solve``'s kernel on an NY x NX
    lattice of ``itemsize``-byte elements: each column is a cluster of
    ``cluster`` blocks of ``threads`` threads; block k owns the rows
    [k seg, (k+1) seg) of the NY - 1 factor rows, and thread t of it the
    run [t run, (t+1) run) of those.  Shared memory holds 32 / itemsize
    rows of a run (71,680 bytes a block: three blocks an SM); the cluster
    is the fewest blocks that hold the column, raised to one block an SM
    when NX is small, but never beyond one row a thread or
    ``MAX_CLUSTER``.  A column that ``MAX_CLUSTER`` blocks do not stage
    (NY > 4,097 in float64, 8,193 in float32) takes as many blocks as one
    wave of the card holds, and its runs' further rows stay in device
    memory.  ``kernel_solve_geometry`` reads the built kernel's own rule."""
    rows = NY - 1
    if rows <= 0:
        return SOLVE_THREADS, 1, 0, 0
    run_max = 32 // itemsize
    fit = -(-rows // (SOLVE_THREADS * run_max))
    if fit <= MAX_CLUSTER:
        cluster = max(fit, min(MAX_CLUSTER, max(1, CARD_SMS // NX),
                               -(-rows // SOLVE_THREADS)))
    else:  # as many blocks as one wave of the card holds (three an SM)
        cluster = min(MAX_CLUSTER, max(1, 3 * CARD_SMS // NX))
    seg = -(-rows // cluster)
    return SOLVE_THREADS, cluster, seg, -(-seg // SOLVE_THREADS)


def line_factor_plain(SS):
    """Factor every x-column's block-tridiagonal (2x2 blocks over NY)
    y-line system by orthogonal (QR) elimination, batched over columns.

    The line operator is the ox = 0 slice: A_d = SS[1,1] (diagonal),
    A_l = SS[0,1] (couples y-1), A_u = SS[2,1] (couples y+1).  As in
    ``BlockTridiagDirect``, fill makes the upper factor block-pentadiagonal
    (R upper triangular, C1 coupling y+1, E coupling y+2) and the level Q
    factors transform the rhs at solve time; the column axis is a batch
    dimension.  Returns (R, C1, E, Q, Qf, Rf)."""
    A_l, A_d, A_u = SS[0, 1], SS[1, 1], SS[2, 1]   # (NY, NX, 2, 2)
    NY, NX = A_d.shape[0], A_d.shape[1]
    zm = torch.zeros((NX, 2, 2), dtype=A_d.dtype, device=A_d.device)
    Rs, C1s, Es, Qs = [], [], [], []
    Dc, Cc = A_d[0], A_u[0]
    for y in range(1, NY):
        M = torch.cat([Dc, A_l[y]], dim=-2)                 # (NX, 4, 2)
        Q, R = torch.linalg.qr(M, mode="complete")          # Q (NX, 4, 4)
        top = torch.cat([Cc, zm], dim=-1)                   # (NX, 2, 4)
        bot = torch.cat([A_d[y], A_u[y]], dim=-1)
        right = Q.transpose(-1, -2) @ torch.cat([top, bot], dim=-2)
        Rs.append(R[:, :2])
        C1s.append(right[:, :2, :2])
        Es.append(right[:, :2, 2:])
        Qs.append(Q)
        Dc, Cc = right[:, 2:, :2], right[:, 2:, 2:]
    Qf, Rf = torch.linalg.qr(Dc, mode="complete")
    if NY == 1:  # no rows to eliminate, as JAX's scan of length 0
        return (*(A_d.new_zeros((0, NX, 2, 2)) for _ in range(3)),
                A_d.new_zeros((0, NX, 4, 4)), Qf, Rf)
    return (torch.stack(Rs), torch.stack(C1s), torch.stack(Es),
            torch.stack(Qs), Qf, Rf)


def line_solve_plain(fac, r):
    """Solve the y-line systems of every column: r (NY, NX, 2)."""
    R, C1, E, Q, Qf, Rf = fac
    NY, NX = r.shape[0], r.shape[1]
    zc, Z = r[0], []
    for y in range(NY - 1):
        v = torch.cat([zc, r[y + 1]], dim=-1)[..., None]     # (NX, 4, 1)
        zz = (Q[y].transpose(-1, -2) @ v)[..., 0]            # (NX, 4)
        Z.append(zz[:, :2])
        zc = zz[:, 2:]
    zl = (Qf.transpose(-1, -2) @ zc[..., None])[..., 0]

    def tri(Rm, v):
        return torch.linalg.solve_triangular(Rm, v[..., None],
                                             upper=True)[..., 0]

    xl = tri(Rf, zl)
    x1 = xl
    x2 = torch.zeros((NX, 2), dtype=r.dtype, device=r.device)
    X = [xl]
    for y in range(NY - 2, -1, -1):
        rhs = (Z[y] - (C1[y] @ x1[..., None])[..., 0]
               - (E[y] @ x2[..., None])[..., 0])
        x = tri(R[y], rhs)
        X.append(x)
        x1, x2 = x, x1
    return torch.stack(X[::-1])                              # (NY, NX, 2)


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_line_factor_f32, lib.cmfem_line_factor_f64):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.cmfem_line_solve_f32, lib.cmfem_line_solve_f64):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_linemg_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_linemg_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernels' library now (it is built lazily)."""
    _lib()


def kernel_solve_geometry(NY, NX, itemsize):
    """``solve_geometry`` as the built kernel has it
    (``csrc/linemg.cu::solve_geometry``, which launches ``line_solve``)."""
    fn = _lib().cmfem_line_solve_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    g = (ctypes.c_int * 4)()
    fn(NY, NX, itemsize, g)
    return tuple(g)


def _check(name, tensors, dtype, device):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: tensors on {t.device} in {t.dtype}, "
                             f"expected {device} in {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16-byte aligned "
                             "(the kernels' bulk copies need it)")


def _launch(fn, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _lib().cmfem_linemg_error_string(err).decode()
        raise RuntimeError(f"linemg kernel launch failed: {msg} ({err})")


def line_factor(SS):
    """(R, C1, E, Q, Qf, Rf) of every x-column's y-line system of the
    canonical stencil SS (3, 3, NY, NX, 2, 2): the kernel on a CUDA tensor,
    ``line_factor_plain`` on the CPU."""
    global launches_factor
    if SS.device.type == "cpu":
        return line_factor_plain(SS)
    if SS.dim() != 6 or tuple(SS.shape[:2]) != (3, 3) \
            or tuple(SS.shape[4:]) != (2, 2):
        raise ValueError(f"line_factor: SS has shape {tuple(SS.shape)}, "
                         f"expected (3, 3, NY, NX, 2, 2)")
    A_l, A_d, A_u = (SS[0, 1].contiguous(), SS[1, 1].contiguous(),
                     SS[2, 1].contiguous())
    _check("line_factor", (A_l, A_d, A_u), SS.dtype, SS.device)
    NY, NX = A_d.shape[0], A_d.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=SS.dtype, device=SS.device)
    R, C1, E = (new(NY - 1, NX, 2, 2) for _ in range(3))
    Q = new(NY - 1, NX, 4, 4)
    Qf, Rf = new(NX, 2, 2), new(NX, 2, 2)
    lib = _lib()
    fn = (lib.cmfem_line_factor_f32 if SS.dtype == torch.float32
          else lib.cmfem_line_factor_f64)
    _launch(fn, [t.data_ptr() for t in (A_l, A_d, A_u, R, C1, E, Q, Qf, Rf)]
            + [NY, NX], SS.device)
    launches_factor += 1
    return R, C1, E, Q, Qf, Rf


def line_solve(fac, r):
    """The y-line solves of every column for r (NY, NX, 2) with
    ``line_factor``'s factors: the kernel on a CUDA tensor,
    ``line_solve_plain`` on the CPU."""
    global launches_solve
    if r.device.type == "cpu":
        return line_solve_plain(fac, r)
    R, C1, E, Q, Qf, Rf = fac
    NY, NX = r.shape[0], r.shape[1]
    want = ((NY - 1, NX, 2, 2),) * 3 + ((NY - 1, NX, 4, 4), (NX, 2, 2),
                                        (NX, 2, 2))
    if r.dim() != 3 or r.shape[2] != 2 or any(
            tuple(t.shape) != w for t, w in zip(fac, want)):
        raise ValueError("line_solve: factors and r (NY, NX, 2) disagree")
    _check("line_solve", (*fac, r), r.dtype, r.device)
    out = torch.empty_like(r)
    lib = _lib()
    fn = (lib.cmfem_line_solve_f32 if r.dtype == torch.float32
          else lib.cmfem_line_solve_f64)
    _launch(fn, [t.data_ptr() for t in (R, C1, E, Q, Qf, Rf, r, out)]
            + [NY, NX], r.device)
    launches_solve += 1
    return out


def bounds(NY, NX, itemsize):
    """{kernel: (ms, "bytes" or "operations")}: the least time the card
    could take for each kernel's work on an NY x NX lattice of 2x2 blocks
    (``kernels.bound``; the operations at the float64 rate).  The
    factorization reads the three stencil planes once and writes the
    factors, ~330 flops a row (two 4-term reflectors applied to 2 + 4
    columns, Q formed); the solve reads the factors and r once and writes
    x, 56 flops a row."""
    rows = (NY - 1) * NX
    fac_bytes = itemsize * (rows * (3 * 4 + 16) + NX * 8)
    return {"line_factor": bound(itemsize * 3 * 4 * NY * NX + fac_bytes,
                                 330 * rows, F64_FLOP_PER_S),
            "line_solve": bound(fac_bytes + 2 * itemsize * 2 * NY * NX,
                                56 * rows, F64_FLOP_PER_S)}


def level_times(SS, fac, r):
    """{kernel: {"ms", "call_ms", "bound_ms", "bound_by"}} of
    ``line_factor(SS)`` and ``line_solve(fac, r)`` on CUDA tensors at one
    level of a hierarchy: ``ms`` the median device ms per call, 10 calls
    replayed from a CUDA graph (``kernels.graph_ms``: the wrappers' host
    work is not in it); ``call_ms`` the median ms of one wrapper call
    between CUDA events, the device time plus what the card waits for the
    host's enqueue (the wrapper's checks, ctypes), as a V-cycle sees it;
    the bound from ``bounds``.  These calls count as launches: read a
    path's counters before timing."""
    calls = {"line_factor": lambda: line_factor(SS),
             "line_solve": lambda: line_solve(fac, r)}
    bnd = bounds(SS.shape[2], SS.shape[3], SS.element_size())
    return {k: {"ms": graph_ms(fn), "call_ms": median_ms(fn, 20, 3),
                "bound_ms": bnd[k][0], "bound_by": bnd[k][1]}
            for k, fn in calls.items()}


def describe(times):
    """One line of ``level_times``' figures."""
    return ", ".join(f"{k} {t['ms']:.4f} ms (a call {t['call_ms']:.4f} ms; "
                     f"bound {t['bound_ms']:.5f} ms, {t['bound_by']})"
                     for k, t in times.items())
