"""The tiled design of the B^T D B kernel (csrc/btdb.cu,
``btdb_tiled_kernel``, hexes at orders 2-4), emulated in numpy on the CPU.

The emulation follows the kernel's indexing step by step: the geometry of
``kernels.btdb.tile_geometry`` (elements per block, padded DOF count, slabs of
quadrature points, threads, ring stages), the thread-to-tile map (a warp is
8 element groups x 4 row groups), BG's tile stream as ``stream_index`` lays
it out and as the ring's slots receive it, the first product into a thread's
8 x 4 registers, the D stage on those registers with the kernel's flat
addresses and its mask of the ragged last block, V through shared memory,
the second product into the y tile, and the masked store.  It is held
against ``btdb_plain`` in float64 to 1e-12 of max|y| (the sums are taken in
another order, <= 500 terms twice) for element counts that are no multiple
of the block (60, 1, 130, 33), below it, equal to it and 0, with the float32 and
the float64 geometry, and once per order against the JAX package's
``_xla_btdb``.  The kernel itself runs only on the card (the ``gpu`` test of
tests/test_torch_partial.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.ops.partial import _xla_btdb

from cmfem_tpu_torch.kernels import btdb as kbtdb
from cmfem_tpu_torch.kernels.btdb import KC, TA, TE, TQ

M = 4
HEX = {2: (27, 27), 3: (64, 64), 4: (125, 125)}  # order -> (nd, nq)


def _thread_map(geo):
    """(eg, g) of every thread of a block, as the kernel computes them."""
    tid = np.arange(geo.THREADS)
    warp, lane = tid // 32, tid % 32
    EG = geo.E // TE
    eg = (warp % (EG // 8)) * 8 + lane % 8
    g = (warp // (EG // 8)) * 4 + lane // 8
    return eg, g


def emulate(BG, u_eT, Dflat, itemsize):
    """The tiled kernel's y_eT, block by block and thread by thread."""
    nd, ne = u_eT.shape
    nq = Dflat.shape[1]
    geo = kbtdb.tile_geometry(nd, nq, itemsize)
    E, NDP, QC, NS = geo.E, geo.NDP, geo.QC, geo.STAGES
    stream = np.concatenate([BG.reshape(-1), [0.0]])[
        kbtdb.stream_index(nd, nq, geo)]
    eg, g = _thread_map(geo)
    cols = TE * eg[:, None] + np.arange(TE)  # a thread's elements
    rows = TA * g[:, None] + np.arange(TA)   # a thread's rows of a product
    u, D = u_eT.reshape(-1), Dflat.reshape(-1)
    y = np.zeros(nd * ne)
    written = np.zeros(nd * ne, dtype=int)
    for block in range(-(-ne // E)):
        e0 = block * E
        left = ne - (e0 + TE * eg)  # elements from each thread's first on
        ring = np.full((NS, KC, NDP), np.nan)
        state = {"t": 0, "slot": 0}

        def fetch(t, slot):
            if t < geo.TILES:
                ring[slot] = stream[t]

        def next_tile():
            t, slot = state["t"], state["slot"]
            fetch(t + NS - 1, NS - 1 if slot == 0 else slot - 1)
            state["t"], state["slot"] = t + 1, (slot + 1) % NS
            return ring[slot].copy()

        for t in range(NS - 1):
            fetch(t, t)
        su = np.zeros((NDP, E))
        for a in range(nd):  # rows nd..NDP-1 stay zero
            for el in range(E):
                if e0 + el < ne:
                    su[a, el] = u[a * ne + e0 + el]
        sV = np.full((NDP, E), np.nan)
        out = np.zeros((geo.THREADS, TA, TE))
        for slab in range(geo.NSLAB):
            acc = np.zeros((geo.THREADS, TA, TE))
            for kt in range(geo.HALF):
                sB = next_tile()
                for kk in range(KC):
                    v = su[kt * KC + kk][cols]
                    b = sB[kk][rows]
                    acc += b[:, :, None] * v[:, None, :]
            for i2 in range(TQ):
                qq = TQ * g + i2
                q = slab * QC + qq
                V = np.zeros((geo.THREADS, M, TE))
                for r in range(M):
                    for s in range(M):
                        addr = (((r * M + s) * nq + q) * ne + e0
                                + TE * eg)[:, None] + np.arange(TE)
                        ok = (q < nq)[:, None] & (np.arange(TE) < left[:, None])
                        d = np.where(ok, D[np.where(ok, addr, 0)], 0.0) \
                            if D.size else np.zeros(addr.shape)
                        V[:, r] += d * acc[:, M * i2 + s]
                for r in range(M):
                    sV[(M * qq + r)[:, None], cols] = V[:, r]
            for jt in range(geo.HALF):
                sB = next_tile()
                for jj in range(KC):
                    v = sV[jt * KC + jj][cols]
                    b = sB[jj][rows]
                    out += b[:, :, None] * v[:, None, :]
        assert state["t"] == geo.TILES
        ok = (rows < nd)[:, :, None] & (np.arange(TE) < left[:, None])[:, None]
        dst = rows[:, :, None] * ne + (e0 + cols)[:, None, :]
        y[dst[ok]] = out[ok]
        np.add.at(written, dst[ok], 1)
    assert (written == 1).all()  # every output stored by exactly one thread
    return y.reshape(nd, ne)


def _inputs(order, ne, seed=0):
    nd, nq = HEX[order]
    rng = np.random.default_rng(seed + 10 * order + ne)
    return (rng.standard_normal((M * nq, nd)), rng.standard_normal((nd, ne)),
            rng.standard_normal((M * M, nq, ne)))


def _plain(BG, u_eT, Dflat):
    return kbtdb.btdb_plain(*(torch.as_tensor(a)
                              for a in (BG, u_eT, Dflat))).numpy()


@pytest.mark.parametrize("order,itemsize,expected", [
    # E, NDP, QC, NSLAB, HALF, TILES, THREADS, STAGES
    (2, 4, (64, 32, 8, 4, 2, 16, 64, 4)),
    (3, 4, (64, 64, 16, 4, 4, 32, 128, 4)),
    (4, 4, (32, 128, 32, 4, 8, 64, 128, 2)),
    (2, 8, (32, 32, 8, 4, 2, 16, 32, 4)),
    (3, 8, (32, 64, 16, 4, 4, 32, 64, 4)),
    (4, 8, (32, 128, 32, 4, 8, 64, 128, 3)),
])
def test_tile_geometry(order, itemsize, expected):
    nd, nq = HEX[order]
    geo = kbtdb.tile_geometry(nd, nq, itemsize)
    assert tuple(geo) == expected
    assert M * geo.QC == geo.NDP >= nd and geo.NSLAB * geo.QC >= nq
    # the resident blocks per SM the ring is sized for fit in shared memory
    smem = itemsize * (2 * geo.NDP * geo.E + geo.STAGES * KC * geo.NDP)
    assert kbtdb.BLOCKS[itemsize] * (smem + 1024) <= kbtdb.SMEM_MAX
    assert geo.THREADS <= kbtdb.THREADS_MAX
    # a tile is copied in 16-byte pieces, the same number by every thread
    assert (KC * geo.NDP * itemsize // 16) % geo.THREADS == 0


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_thread_map_covers_the_tile_once(order, itemsize):
    geo = kbtdb.tile_geometry(*HEX[order], itemsize)
    eg, g = _thread_map(geo)
    cells = np.zeros((geo.NDP, geo.E), dtype=int)
    rows = TA * g[:, None] + np.arange(TA)
    cols = TE * eg[:, None] + np.arange(TE)
    np.add.at(cells, (rows[:, :, None], cols[:, None, :]), 1)
    assert (cells == 1).all()
    # a warp's operand loads: 8 element groups in a row, 4 row groups
    for w in range(geo.THREADS // 32):
        assert np.ptp(eg[32 * w:32 * w + 32]) == 7
        assert np.ptp(g[32 * w:32 * w + 32]) == 3


@pytest.mark.parametrize("order", [2, 3, 4])
def test_stream_holds_bg_once_per_product(order):
    nd, nq = HEX[order]
    geo = kbtdb.tile_geometry(nd, nq, 4)
    idx = kbtdb.stream_index(nd, nq, geo)
    assert idx.shape == (geo.TILES, KC, geo.NDP)
    zero = M * nq * nd
    per_slab = idx.reshape(geo.NSLAB, 2, geo.HALF * KC * geo.NDP)
    for product in range(2):
        used = per_slab[:, product].reshape(-1)
        used = used[used != zero]
        np.testing.assert_array_equal(np.sort(used), np.arange(zero))
    # the two layouts of a slab are transposes of one another
    c = idx.reshape(geo.NSLAB, 2, geo.NDP, geo.NDP)
    np.testing.assert_array_equal(c[:, 0], c[:, 1].transpose(0, 2, 1))


@pytest.mark.parametrize("ne", [60, 1, 0, 64, 130, 33])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_tile_emulation_matches_plain(order, itemsize, ne):
    BG, u_eT, Dflat = _inputs(order, ne)
    y = emulate(BG, u_eT, Dflat, itemsize)
    y_ref = _plain(BG, u_eT, Dflat)
    assert y.shape == y_ref.shape == (HEX[order][0], ne)
    if ne:
        err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
        assert err <= 1e-12, err


@pytest.mark.parametrize("order", [2, 3, 4])
def test_tile_emulation_matches_xla_btdb(order):
    nd, nq = HEX[order]
    BG, u_eT, Dflat = _inputs(order, 37, seed=2)
    y_ref = np.asarray(_xla_btdb(BG, nq, M, dtype=jnp.float64)(
        jnp.asarray(u_eT), jnp.asarray(Dflat)))
    y = emulate(BG, u_eT, Dflat, 4)
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


@pytest.mark.parametrize("order", [2, 3, 4])
def test_pack_bg_is_the_stream(order):
    nd, nq = HEX[order]
    BG = torch.as_tensor(_inputs(order, 1)[0])
    geo = kbtdb.tile_geometry(nd, nq, BG.element_size())
    packed = kbtdb.pack_bg(BG, M, nq)
    ref = np.concatenate([BG.numpy().reshape(-1), [0.0]])[
        kbtdb.stream_index(nd, nq, geo)]
    np.testing.assert_array_equal(packed.numpy(), ref)


def test_pack_bg_leaves_untiled_bg_alone_and_cpu_operators_pack_nothing():
    assert kbtdb.pack_bg(torch.zeros((M * 8, 8)), M, 8) is None
    assert kbtdb.pack_bg(torch.zeros((3 * 16, 16)), 3, 16) is None
    assert set(kbtdb.TILED_SHAPES) <= set(kbtdb.KERNEL_SHAPES)
    from cmfem_tpu_torch.ops.partial import PAOperator
    rng = np.random.default_rng(3)
    op = PAOperator.from_arrays(
        rng.standard_normal((16, 27, 2)), rng.standard_normal((108, 27)),
        np.arange(54).reshape(2, 27), 54, device="cpu", dtype=torch.float64)
    assert op.BG_stream is None
    assert torch.isfinite(op(torch.ones(54, dtype=torch.float64))).all()
