"""The element-batched B^T D B apply: CUDA kernel wrapper + plain version.

``btdb_apply(BG, u_eT, Dflat)`` computes ``y_eT = BG^T (D (BG u_eT))`` per
element in the transposed layout of ``ops.partial.pack_qp_blocks_T``.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/btdb.cu`` (which
replaces ``cmfem_tpu/ops/partial.py::_pallas_btdb``, the TPU's element-tile
Pallas kernel); on a CPU tensor it runs ``btdb_plain``, the plain PyTorch
version (a port of ``_xla_btdb``).  There is no fallback from one to the
other.

The kernel takes every element shape (m, nd, nq) that the JAX package's
spaces produce at orders 1-4 (``KERNEL_SHAPES``).  Hexes at orders 2-4 take
its tiled design: a block of
``tile_geometry(...).E`` elements, both products register-tiled, BG read as
a stream of (16, NDP) tiles that ``pack_bg`` lays out once per BG (the
operators do it at construction and hand the stream to every apply).  The
geometry is decided here and checked by the C entry, which computes its own,
on every launch.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import numpy as np
import torch

from .build import build_info, load_library, ptxas_resources

# (m, nd, nq) the kernel takes: every shape ``SpaceOps`` of the JAX package
# produces for triangles and quads (m = 3), tets and hexes (m = 4) at orders
# p = 1-4 under the quadrature orders its forms and drivers use (2p in
# ``__graft_entry__``, bench.py and multigrid; the default 2p + 1; 2p + 2 in
# the ablation drivers; 2p + 3 in ``linear_cd_transient``'s error space; 4
# in the ablation and dry-run set-ups), that is q1 = p + 1, p + 2 or 3 Gauss
# (conical-product) points per axis, nq = q1^dim.  Its spaces have no
# segments (``FESpace`` has no boundary for them).  nq is a runtime bound
# of the kernel; nd and m are compiled in (csrc/btdb.cu::dispatch).
KERNEL_SHAPES = frozenset({
    # triangles
    (3, 3, 4), (3, 3, 9), (3, 6, 9), (3, 6, 16), (3, 10, 9), (3, 10, 16),
    (3, 10, 25), (3, 15, 9), (3, 15, 25), (3, 15, 36),
    # quads
    (3, 4, 4), (3, 4, 9), (3, 9, 9), (3, 9, 16), (3, 16, 9), (3, 16, 16),
    (3, 16, 25), (3, 25, 9), (3, 25, 25), (3, 25, 36),
    # tets
    (4, 4, 8), (4, 4, 27), (4, 10, 27), (4, 10, 64), (4, 20, 27),
    (4, 20, 64), (4, 20, 125), (4, 35, 27), (4, 35, 125), (4, 35, 216),
    # hexes
    (4, 8, 8), (4, 8, 27), (4, 27, 27), (4, 27, 64), (4, 64, 27),
    (4, 64, 64), (4, 64, 125), (4, 125, 27), (4, 125, 125), (4, 125, 216),
})
# the DOF counts of the tiled design: hexes at orders 2-4, at any nq
TILED_ND = (27, 64, 125)
TILED_SHAPES = frozenset(s for s in KERNEL_SHAPES
                         if s[0] == 4 and s[1] in TILED_ND)
SMEM_MAX = 232448  # bytes of shared memory a block may use on the H100
LIB_NAME = "cmfem_btdb"
SOURCES = ["btdb.cu"]

# the tiled design's tile: a thread holds TA rows x TE elements of a product
# and TQ quadrature points of a slab; a stream tile has KC rows
TE, TA, TQ, KC = 4, 8, 2, 16
# its block: at most E_MAX[item size] elements and THREADS_MAX threads, a
# ring of at most STAGES_MAX tiles that leaves BLOCKS[item size] resident
# blocks per SM their shared memory (csrc/btdb.cu::Tile has the same)
E_MAX = {4: 64, 8: 32}
THREADS_MAX, STAGES_MAX = 128, 4
BLOCKS = {4: 4, 8: 2}

# Calls of the wrapper that launched the kernel.  Plain-version calls do
# not count.
launches = 0


class TileGeometry(NamedTuple):
    E: int        # elements per block
    NDP: int      # DOFs padded to a multiple of 32; also the rows of a slab
    QC: int       # quadrature points per slab, NDP // 4
    NSLAB: int    # slabs, ceil(nq / QC)
    HALF: int     # stream tiles per product and slab, NDP // KC
    TILES: int    # tiles in the stream, NSLAB * 2 * HALF
    THREADS: int  # (E // TE) element groups x (NDP // TA) row groups
    STAGES: int   # tiles in the ring


@functools.cache
def tile_geometry(nd: int, nq: int, itemsize: int) -> TileGeometry:
    """The tiled design's geometry for hexes with nd DOFs and nq points.

    A block of THREADS = EG * AG threads owns E consecutive elements; thread
    (eg, g) holds elements 4 eg .. 4 eg + 3 and rows 8 g .. 8 g + 7 of either
    product.  Thread tid sits in warp tid // 32 at lane tid % 32, with
    eg = (warp % (EG // 8)) * 8 + lane % 8 and
    g = (warp // (EG // 8)) * 4 + lane // 8."""
    NDP = -(-nd // 32) * 32
    AG = NDP // TA
    E = E_MAX[itemsize]
    while E > 32 and E // TE * AG > THREADS_MAX:
        E //= 2
    threads = E // TE * AG
    room = SMEM_MAX // BLOCKS[itemsize] - 1024 - 2 * NDP * E * itemsize
    stages = min(STAGES_MAX, room // (KC * NDP * itemsize))
    if stages < 2 or (KC * NDP * itemsize // 16) % threads:
        raise ValueError(f"tile_geometry: nd={nd} at item size {itemsize} "
                         f"does not tile")
    QC = TQ * AG
    NSLAB, HALF = -(-nq // QC), NDP // KC
    return TileGeometry(E, NDP, QC, NSLAB, HALF, NSLAB * 2 * HALF, threads,
                        stages)


def stream_index(nd: int, nq: int, geo: TileGeometry) -> np.ndarray:
    """(TILES, KC, NDP) indices into [BG.reshape(-1), 0]: BG (4*nq, nd) as
    the tiled kernel consumes it.

    Row j of slab c stands for (q, s) = (c*QC + j // 4, j % 4), BG row
    s*nq + q.  Per slab, HALF tiles for the first product, tile kt holding
    [kk][j] = BG[row(j), kt*KC + kk], then HALF tiles for the second, tile
    jt holding [jj][a] = BG[row(jt*KC + jj), a]; the entry past BG's end
    (a zero) where q >= nq or the DOF index >= nd."""
    zero = 4 * nq * nd
    NDP, HALF = geo.NDP, geo.HALF
    idx = np.full((geo.NSLAB, 2 * HALF, KC, NDP), zero, dtype=np.int64)
    j = np.arange(NDP)
    dof = np.arange(NDP)
    for c in range(geo.NSLAB):
        q = c * geo.QC + j // 4
        row = np.where(q < nq, (j % 4) * nq + q, -1)
        entry = np.where((row[:, None] >= 0) & (dof[None, :] < nd),
                         row[:, None] * nd + dof[None, :], zero)  # [j][dof]
        idx[c, :HALF] = entry.T.reshape(HALF, KC, NDP)  # [kt][kk][j]
        idx[c, HALF:] = entry.reshape(HALF, KC, NDP)    # [jt][jj][a]
    return idx.reshape(geo.TILES, KC, NDP)


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


def pack_bg(BG, m: int, nq: int):
    """BG's tile stream (TILES, KC, NDP) for the tiled design, by one gather
    on BG's device; None for a shape of the one-thread-per-element design,
    which takes BG as it is.  An operator on a CUDA device packs its BG once
    and hands the stream to every apply."""
    nd = BG.shape[1]
    if (m, nd, nq) not in TILED_SHAPES:
        return None
    geo = tile_geometry(nd, nq, BG.element_size())
    idx = torch.as_tensor(stream_index(nd, nq, geo), device=BG.device)
    return torch.cat([BG.reshape(-1), BG.new_zeros(1)])[idx]


@functools.cache
def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    for fn in (lib.cmfem_btdb_apply_f32, lib.cmfem_btdb_apply_f64):
        # BG, u, D, y, m, nd, nq, ne, e, ndp, threads, stages, tiles, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cmfem_btdb_tiled_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.cmfem_btdb_tiled_blocks_per_sm.restype = ctypes.c_int
    lib.cmfem_btdb_error_string.argtypes = [ctypes.c_int]
    lib.cmfem_btdb_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build and load the kernel's library now (it is built lazily)."""
    _lib()


def tiled_kernel_resources() -> dict[str, tuple[int, int]]:
    """{"float nd=64 wide": (registers, spill bytes), ...} of the tiled
    kernel's instantiations, from ptxas -v of the loaded library ("wide":
    16-byte accesses to u, D and y, the launch for ne a multiple of 4;
    "narrow": element by element)."""
    found = ptxas_resources(build_info(LIB_NAME)[1], "btdb_tiled_kernel")
    out = {}
    for name, res in found.items():
        m = re.search(r"btdb_tiled_kernelI([fd]).*?4TileI[fd]Li(\d+)E"
                      r".*?Lb([01])E", name)
        out[f"{'float' if m[1] == 'f' else 'double'} nd={m[2]} "
            f"{'wide' if m[3] == '1' else 'narrow'}"] = res
    return out


def tiled_blocks_per_sm(nd: int, itemsize: int) -> int:
    """Resident blocks per SM of the tiled kernel on the current device."""
    n = _lib().cmfem_btdb_tiled_blocks_per_sm(nd, itemsize)
    if n <= 0:
        raise RuntimeError(f"no tiled kernel for nd={nd}, item size "
                           f"{itemsize} (returned {n})")
    return n


def require_kernel(device, dtype, m: int, nd: int, nq: int):
    """Raise unless the kernel takes (m, nd, nq) tensors of ``dtype`` on
    ``device``: a CUDA device, f32 or f64, a shape in KERNEL_SHAPES."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"btdb_apply: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"btdb_apply: dtype {dtype} not supported")
    if (m, nd, nq) not in KERNEL_SHAPES:
        raise ValueError(f"btdb_apply: (m, nd, nq) = ({m}, {nd}, {nq}) is "
                         f"not one of {sorted(KERNEL_SHAPES)}")


def btdb_apply(BG, u_eT, Dflat, packed=None):
    """y_eT (nd, ne): the CUDA kernel on a CUDA tensor, the plain version on
    CPU.  ``packed`` is ``pack_bg(BG, m, nq)`` where the caller keeps it (the
    operators do); without it a tiled shape packs BG in this call.  Raises
    on anything the kernel does not take (device, dtype, a shape outside
    KERNEL_SHAPES, a non-contiguous tensor, a stream of another geometry)."""
    global launches
    if u_eT.device.type == "cpu":
        return btdb_plain(BG, u_eT, Dflat)
    if Dflat.dim() != 3 or BG.dim() != 2 or u_eT.dim() != 2:
        raise ValueError("btdb_apply: expected BG (m*nq, nd), u_eT (nd, ne),"
                         " Dflat (m*m, nq, ne)")
    mm, nq, ne = Dflat.shape
    nd = u_eT.shape[0]
    m = int(round(mm ** 0.5))
    if m * m != mm:
        raise ValueError(f"btdb_apply: Dflat has {mm} blocks, not m*m")
    require_kernel(u_eT.device, u_eT.dtype, m, nd, nq)
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
    geometry = (0, 0, 0, 0, 0)  # the one-thread-per-element design
    y = torch.empty_like(u_eT)
    with torch.cuda.device(u_eT.device):
        if (m, nd, nq) in TILED_SHAPES:
            geo = tile_geometry(nd, nq, u_eT.element_size())
            geometry = (geo.E, geo.NDP, geo.THREADS, geo.STAGES, geo.TILES)
            if packed is None:
                packed = pack_bg(BG, m, nq)
            want = (geo.TILES, KC, geo.NDP)
            if (tuple(packed.shape) != want or packed.dtype != BG.dtype
                    or packed.device != BG.device
                    or not packed.is_contiguous()):
                raise ValueError(f"btdb_apply: packed is not pack_bg's "
                                 f"stream {want} of BG")
            BG = packed
        stream = torch.cuda.current_stream(u_eT.device).cuda_stream
        err = fn(BG.data_ptr(), u_eT.data_ptr(), Dflat.data_ptr(),
                 y.data_ptr(), m, nd, nq, ne, *geometry, stream)
    if err != 0:
        msg = lib.cmfem_btdb_error_string(err).decode()
        raise RuntimeError(f"btdb kernel launch failed: {msg} ({err})")
    launches += 1
    return y
