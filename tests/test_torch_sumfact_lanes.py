"""The lane mapping of the sum-factorization kernel (csrc/sumfact_fused.cu,
``sumfact_lane_kernel``), emulated in numpy on the CPU.

The emulation below follows the kernel's indexing step by step: the launch
geometry of ``kernels.sumfact.launch_geometry`` (elements per warp, warps per
block, blocks), one lane per (element, qx, qy) column with the z-lines in
registers, idle lanes that compute element 0, every ``__shfl_sync`` as a
gather over the 32 lanes of a warp (source lane taken mod 32), the tables
read as the kernel reads them, and the scatter: a plain store for a DOF
interior to its element, ``np.add.at`` (the kernel's ``atomicAdd``) for any
DOF on a face, edge or vertex.  It is held against ``sumfact_chain`` in
float64 to 1e-12 of max|y| (the sums are taken in another order) at orders
1-4 on the ragged grids (3,4,5) and (7,5,9), on Dz and on full D, for the
uniform, kappa(z) and distorted forms, and once against JAX's B2 in Pallas
interpret mode.  The kernel itself runs only on the card (the ``gpu`` tests
of tests/test_torch_sumfact.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_3d as j_mesh3d
from cmfem_tpu.ops import BilinearForm as JForm, SpaceOps as JSpaceOps
from cmfem_tpu.ops.sumfact import SumFactoredOperator as JSumFact

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
from cmfem_tpu_torch.kernels import sumfact as ksum
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops.sumfact import SumFactoredOperator

BETA = np.array([1.0, -2.0, 0.5])
DT = 1e-2
GRIDS = [(3, 4, 5), (7, 5, 9)]


def distort(v):
    """x + 0.03 prod_d (1 + x_d) sin(pi x_d): a smooth interior displacement
    that fixes the unit cube's boundary."""
    return v + 0.03 * np.prod((1 + v) * np.sin(np.pi * v), axis=1,
                              keepdims=True)


def _operator(n, order, form):
    mesh = make_cartesian_mesh_3d(*n)
    if form == "distorted":
        mesh = mesh.with_vertices(distort(mesh.vertices))
    ops = SpaceOps(FESpace(mesh, order), quad_order=2 * order, device="cpu")
    f = BilinearForm(ops).add_mass(1.0).add_convection(BETA, alpha=DT)
    if form == "uniform":
        f = f.add_diffusion(0.1 * DT)
    else:
        f = f.add_diffusion(lambda x: DT * (0.1 + x[:, 2] ** 2))
    return SumFactoredOperator(ops, f.assemble(), *n, order, device="cpu",
                               dtype=torch.float64)


def _lane_elements(p, n):
    """Per lane of the launch (blocks * warps * 32 of them, in launch
    order): its element index, whether it is active, and its lane."""
    per_warp, warps, blocks = ksum.launch_geometry(p, *n)
    n2 = (p + 1) ** 2
    lane = np.tile(np.arange(32), blocks * warps)
    warp_id = np.repeat(np.arange(blocks * warps), 32)  # block * warps + warp
    group = lane // n2
    eid = warp_id * per_warp + group
    active = (group < per_warp) & (eid < n[0] * n[1] * n[2])
    return eid, active, lane


def emulate(u, D, tab, n, p, periodic):
    """The lane kernel's y = A u, lane by lane, in numpy."""
    nx, ny, nz = n
    N, N2 = p + 1, (p + 1) ** 2
    B, G = tab  # B[q][a]
    eid, active, lane = _lane_elements(p, n)
    group = lane // N2
    r = lane - group * N2
    qy, qx = r // N, r % N
    base = group * N2
    e = np.where(active, eid, 0)
    i, rest = e % nx, e // nx
    j, k = rest % ny, rest // ny
    NX = nx * p + 1
    NXY = NX * (ny * p + 1)
    g0 = k * p * NXY + (j * p + qy) * NX + (i * p + qx)
    Kx, KK = nx * N, ny * N * nx * N
    plane = (N if periodic else nz * N) * KK
    d = (0 if periodic else k * N * KK) + (j * N + qy) * Kx + (i * N + qx)
    cz = np.arange(N)
    L = lane.size

    def shfl(x, src):
        """__shfl_sync: each lane reads x (L, N) at lane src mod 32 of its
        own warp."""
        warp_first = np.arange(L) - lane
        return x[warp_first + src % 32]

    def col(v):
        return v[:, None]

    uz = u[g0[:, None] + cz * NXY]
    t0, tx = np.zeros((L, N)), np.zeros((L, N))
    for a in range(N):  # x, against rows B[qx], G[qx]
        v = shfl(uz, base + qy * N + a)
        t0 += col(B[qx, a]) * v
        tx += col(G[qx, a]) * v
    s00, s10, s01 = (np.zeros((L, N)) for _ in range(3))
    for b in range(N):  # y, against rows B[qy], G[qy]
        src = base + b * N + qx
        v0, v1 = shfl(t0, src), shfl(tx, src)
        s00 += col(B[qy, b]) * v0
        s10 += col(B[qy, b]) * v1
        s01 += col(G[qy, b]) * v0
    W = np.zeros((4, L, N))
    Df = D.reshape(-1)
    for qz in range(N):  # z at loop-counter addresses, then D
        V0 = sum(B[qz, c] * s00[:, c] for c in range(N))
        V1 = sum(B[qz, c] * s10[:, c] for c in range(N))
        V2 = sum(B[qz, c] * s01[:, c] for c in range(N))
        V3 = sum(G[qz, c] * s00[:, c] for c in range(N))
        dm = [Df[d + qz * KK + m * plane] for m in range(10)]
        W[0, :, qz] = dm[0] * V0 + dm[1] * V1 + dm[2] * V2 + dm[3] * V3
        W[1, :, qz] = dm[4] * V1 + dm[5] * V2 + dm[6] * V3
        W[2, :, qz] = dm[5] * V1 + dm[7] * V2 + dm[8] * V3
        W[3, :, qz] = dm[6] * V1 + dm[8] * V2 + dm[9] * V3
    r0 = W[0] @ B + W[3] @ G  # z^T: r[c] = sum_qz B[qz][c] W[qz]
    rx, ry = W[1] @ B, W[2] @ B
    s0, sx = np.zeros((L, N)), np.zeros((L, N))
    for q in range(N):  # y^T, against columns B[:, qy], G[:, qy]
        src = base + q * N + qx
        s0 += col(B[q, qy]) * shfl(r0, src) + col(G[q, qy]) * shfl(ry, src)
        sx += col(B[q, qy]) * shfl(rx, src)
    acc = np.zeros((L, N))
    for q in range(N):  # x^T, against columns B[:, qx], G[:, qx]
        src = base + qy * N + q
        acc += col(B[q, qx]) * shfl(s0, src) + col(G[q, qx]) * shfl(sx, src)
    y = np.zeros_like(u)
    dst = g0[:, None] + cz * NXY
    inner = (col((qx > 0) & (qx < p) & (qy > 0) & (qy < p))
             & (cz > 0) & (cz < p))
    inner &= col(active)
    atomic = col(active) & ~inner
    assert np.unique(dst[inner]).size == inner.sum()  # one writer each
    y[dst[inner]] = acc[inner]
    np.add.at(y, dst[atomic], acc[atomic])
    return y


@pytest.mark.parametrize("p,per_warp", [(1, 8), (2, 3), (3, 2), (4, 1)])
def test_launch_geometry_groups_per_warp(p, per_warp):
    got, warps, blocks = ksum.launch_geometry(p, 48, 48, 48)
    assert (got, warps) == (per_warp, ksum.WARPS_PER_BLOCK)
    assert per_warp * (p + 1) ** 2 <= 32 < (per_warp + 1) * (p + 1) ** 2
    assert blocks == -(-48 ** 3 // (per_warp * warps))
    with pytest.raises(ValueError):
        ksum.launch_geometry(5, 2, 2, 2)


@pytest.mark.parametrize("n", GRIDS + [(48, 48, 48), (1, 1, 1), (25, 1, 2)])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_launch_geometry_covers_each_element_once(p, n):
    per_warp, warps, blocks = ksum.launch_geometry(p, *n)
    eid, active, lane = _lane_elements(p, n)
    first = lane % (p + 1) ** 2 == 0  # one lane per group
    got = eid[active & first]
    n_el = n[0] * n[1] * n[2]
    np.testing.assert_array_equal(got, np.arange(n_el))
    # no empty block: the last block holds at least one element
    assert (blocks - 1) * per_warp * warps < n_el <= blocks * per_warp * warps


@pytest.mark.parametrize("form", ["uniform", "kappa_z", "distorted"])
@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_lane_emulation_matches_plain_chain(p, n, form):
    op = _operator(n, p, form)
    assert op.compressed and op.z_periodic == (form == "uniform")
    u = np.random.default_rng(p).standard_normal(op.ndofs)
    tab = op.tab.numpy()
    for periodic in (True, False) if op.z_periodic else (False,):
        D = op.Dz if periodic else op.D
        y_ref = ksum.sumfact_chain(torch.as_tensor(u), D, op._mats,
                                   periodic).numpy()
        y = emulate(u, D.numpy(), tab, n, p, periodic)
        err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
        assert err <= 1e-12, (periodic, err)


def test_lane_emulation_matches_jax_b2():
    """One small case against JAX's B2 (the fused z-FMA kernel on Dz) in
    Pallas interpret mode."""
    n, order = (2, 3, 4), 2
    jops = JSpaceOps(JFESpace(j_mesh3d(*n), order), quad_order=2 * order)
    jdata = (JForm(jops).add_mass(1.0).add_convection(BETA, alpha=DT)
             .add_diffusion(0.1 * DT).assemble())
    jop = JSumFact(jops, jdata, *n, order, dtype=jnp.float64)
    op = _operator(n, order, "uniform")
    u = np.random.default_rng(7).standard_normal(op.ndofs)
    jf, jD = jop.bind(use_fused=True, z_fma=True, use_periodic=True,
                      interpret=True)
    y_ref = np.asarray(jf(jnp.asarray(u), jD))
    y = emulate(u, op.Dz.numpy(), op.tab.numpy(), n, order, True)
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
