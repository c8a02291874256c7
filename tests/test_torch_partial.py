"""Port parity, element-batched partial assembly: cmfem_tpu_torch.ops.partial
(PAOperator, StructuredPAOperator), kernels.btdb and interop.lattice_index
against cmfem_tpu.ops.partial on the same forms and numpy-seeded vectors.

Nothing in the JAX package runs its TPU kernel B1 (``_pallas_btdb``) on the
CPU, so the port's plain version ``btdb_plain`` is held against B1's XLA
twin ``_xla_btdb`` (1e-13 max|y|, float64), and the operators against JAX's
with ``use_pallas=False`` (1e-12, float64), with the variable conductivity
kappa = 0.1 + z^2 (0.1 + y^2 on quads).  The CUDA kernel runs only on the
card: the test marked ``gpu`` holds it against the plain version there
(float64 to 1e-12 max|y|; float32 to 1e-5 max|y|: each output sums
m*nq <= 500 products twice, in another order), at every instantiated
shape, hexes and quads at orders 1-4, with element counts that are no
multiple of the block or of 4, on another stream, and twice (the kernel has
no atomics: two calls agree bitwise).  The tiled design's indexing (hexes at
orders 2-4) is emulated on the CPU in tests/test_torch_partial_tiles.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import (
    FESpace as JFESpace,
    make_cartesian_mesh_2d as j_mesh2d,
    make_cartesian_mesh_3d as j_mesh3d,
)
from cmfem_tpu.ops import BilinearForm as JForm, SpaceOps as JSpaceOps
from cmfem_tpu.ops.partial import (
    PAOperator as JPA,
    StructuredGrid3D as JGrid,
    StructuredPAOperator as JSPA,
    _xla_btdb,
    pack_qp_blocks_T as j_pack,
)

from cmfem_tpu_torch.core import (
    FESpace,
    make_cartesian_mesh_2d,
    make_cartesian_mesh_3d,
)
from cmfem_tpu_torch.interop import lattice_index, pa_operator_from_arrays
from cmfem_tpu_torch.kernels import btdb as kbtdb
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops.partial import (
    PAOperator,
    StructuredGrid3D,
    StructuredPAOperator,
    pack_qp_blocks_T,
)

DT = 1e-2


def _form(form_cls, ops, dim):
    beta = np.array([1.0, -2.0, 0.5])[:dim]
    return (form_cls(ops).add_mass(1.0).add_convection(beta, alpha=DT)
            .add_diffusion(lambda x: DT * (0.1 + x[:, dim - 1] ** 2)))


def _pair(dim, order, n=3):
    """(jops, jdata, ops, data) for the variable-conductivity form on an
    n^dim lattice."""
    if dim == 3:
        jmesh, mesh = j_mesh3d(n, n, n), make_cartesian_mesh_3d(n, n, n)
    else:
        jmesh, mesh = j_mesh2d(n, n + 1), make_cartesian_mesh_2d(n, n + 1)
    jops = JSpaceOps(JFESpace(jmesh, order), quad_order=2 * order)
    ops = SpaceOps(FESpace(mesh, order), quad_order=2 * order, device="cpu")
    return (jops, _form(JForm, jops, dim).assemble(), ops,
            _form(BilinearForm, ops, dim).assemble())


def _jax_bg(jops, jdata, local_perm=None):
    return j_pack(jops, jdata, jnp.float64, local_perm=local_perm)[1]


def _check(y, y_ref, tol):
    y_ref = np.asarray(y_ref)
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y.numpy() / scale, y_ref / scale, atol=tol)


@pytest.mark.parametrize("m,nd,nq", [(4, 27, 27), (3, 9, 9), (4, 8, 27),
                                     (4, 64, 64)])
def test_btdb_plain_matches_xla_btdb(m, nd, nq):
    rng = np.random.default_rng(m * 100 + nd)
    ne = 37
    BG = rng.standard_normal((m * nq, nd))
    u_eT = rng.standard_normal((nd, ne))
    Dflat = rng.standard_normal((m * m, nq, ne))
    y_ref = _xla_btdb(BG, nq, m, dtype=jnp.float64)(jnp.asarray(u_eT),
                                                    jnp.asarray(Dflat))
    args = [torch.as_tensor(a) for a in (BG, u_eT, Dflat)]
    _check(kbtdb.btdb_plain(*args), y_ref, 1e-13)
    before = kbtdb.launches
    _check(kbtdb.btdb_apply(*args), y_ref, 1e-13)  # CPU: the plain version
    assert kbtdb.launches == before


@pytest.mark.parametrize("dim", [3, 2])
def test_btdb_plain_order4_matches_xla_btdb(dim):
    """Order 4 on assembled forms: hexes on (2,2,2), (m, nd, nq) =
    (4, 125, 125), and quads on (2,3), (3, 25, 25); each package packs its
    own form (1e-12 max|y|, float64)."""
    jops, jdata, ops, data = _pair(dim, 4, n=2)
    jDflat, jBG = j_pack(jops, jdata, jnp.float64)
    Dflat, BG = pack_qp_blocks_T(ops, data, torch.float64)
    m, nd = dim + 1, 5 ** dim
    assert tuple(BG.shape) == (m * nd, nd) and (m, nd, nd) in \
        kbtdb.KERNEL_SHAPES
    u_eT = np.random.default_rng(dim).standard_normal((nd, Dflat.shape[2]))
    y_ref = _xla_btdb(jBG, nd, m, dtype=jnp.float64)(jnp.asarray(u_eT),
                                                     jDflat)
    _check(kbtdb.btdb_plain(BG, torch.as_tensor(u_eT), Dflat), y_ref, 1e-12)


@pytest.mark.parametrize("dim,order", [(3, 1), (3, 2), (3, 3),
                                       (2, 1), (2, 2), (2, 3)])
def test_pa_operator_matches_jax(dim, order):
    jops, jdata, ops, data = _pair(dim, order)
    jop = JPA(jops, jdata, dtype=jnp.float64, use_pallas=False)
    op = PAOperator(ops, data, dtype=torch.float64)
    assert op.m == jop.m == dim + 1
    np.testing.assert_array_equal(op.eldofs_T.numpy().T,
                                  np.asarray(jop.eldofs))
    u = np.random.default_rng(order).standard_normal(op.nscalar)
    y_ref = jop(jnp.asarray(u))
    _check(op(torch.as_tensor(u)), y_ref, 1e-12)
    fn, Dflat, eldofs_T = op.bind()
    assert eldofs_T.is_contiguous()
    _check(fn(torch.as_tensor(u), Dflat, eldofs_T), y_ref, 1e-12)
    # the JAX package's packed arrays carried across give the same operator
    op2 = pa_operator_from_arrays(np.asarray(jop.Dflat),
                                  np.asarray(_jax_bg(jops, jdata)),
                                  np.asarray(jop.eldofs),
                                  nscalar=ops.fes.nscalar, device="cpu",
                                  dtype=torch.float64)
    assert op2.nscalar == op.nscalar
    _check(op2(torch.as_tensor(u)), y_ref, 1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_structured_pa_operator_matches_jax(order):
    n = 3
    jops, jdata, ops, data = _pair(3, order, n)
    grid, jgrid = StructuredGrid3D(n, n, n, order), JGrid(n, n, n, order)
    jop = JSPA(jops, jdata, jgrid, dtype=jnp.float64, use_pallas=False)
    op = StructuredPAOperator(ops, data, grid, dtype=torch.float64)
    u = np.random.default_rng(10 + order).standard_normal(grid.ndofs)
    y_ref = jop(jnp.asarray(u))
    _check(op(torch.as_tensor(u)), y_ref, 1e-12)
    plain = StructuredPAOperator(ops, data, grid, dtype=torch.float64,
                                 use_kernel=False)
    _check(plain(torch.as_tensor(u)), y_ref, 1e-12)
    op2 = pa_operator_from_arrays(
        np.asarray(jop.Dflat), np.asarray(_jax_bg(jops, jdata,
                                                  jgrid.local_perm)),
        grid=grid, device="cpu", dtype=torch.float64)
    _check(op2(torch.as_tensor(u)), y_ref, 1e-12)
    # the same operator in entity numbering, moved by lattice_index
    lat = lattice_index(ops.fes, grid)
    y_ent = PAOperator(ops, data, dtype=torch.float64)(torch.as_tensor(u[lat]))
    _check(y_ent, np.asarray(y_ref)[lat], 1e-12)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_lattice_index_matches_positions_and_survives_distortion(order):
    nx, ny, nz = 2, 3, 4
    mesh = make_cartesian_mesh_3d(nx, ny, nz, sx=2.0, sy=1.5, sz=1.0)
    fes = FESpace(mesh, order)
    grid = StructuredGrid3D(nx, ny, nz, order)
    lat = lattice_index(fes, grid)
    # on the undistorted lattice, the lattice of the node positions
    pos = np.asarray(fes.node_positions)
    idx = [np.searchsorted(np.unique(np.round(pos[:, d], 12)),
                           np.round(pos[:, d], 12)) for d in range(3)]
    np.testing.assert_array_equal(
        lat, (idx[2] * grid.NY + idx[1]) * grid.NX + idx[0])
    # topology only: a distorted lattice gives the same permutation
    v = mesh.vertices
    moved = mesh.with_vertices(v + 0.03 * np.prod(np.sin(np.pi * v), axis=1,
                                                  keepdims=True))
    np.testing.assert_array_equal(lattice_index(FESpace(moved, order), grid),
                                  lat)
    with pytest.raises(ValueError):
        lattice_index(fes, StructuredGrid3D(ny, nx, nz, order))


def test_btdb_wrapper_refuses_other_devices():
    rng = np.random.default_rng(0)
    BG, u, D = (torch.as_tensor(rng.standard_normal(s)).to("meta")
                for s in ((4 * 8, 8), (8, 5), (16, 8, 5)))
    with pytest.raises(ValueError, match="unsupported device"):
        kbtdb.btdb_apply(BG, u, D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_err(args):
    before = kbtdb.launches
    yk = kbtdb.btdb_apply(*args)
    assert kbtdb.launches == before + 1
    yp = kbtdb.btdb_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(yk).all()
    return float((yk - yp).abs().max() / yp.abs().max()), yk


@pytest.mark.gpu
def test_cuda_btdb_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for m, nd, nq in kbtdb.KERNEL_SHAPES:
        # no multiple of the block; for the tiled design (hexes at orders
        # 2-4) also no multiple of 4 (scalar loads), below one block, 1
        nes = [1000 + nd]
        if (m, nd, nq) in kbtdb.TILED_SHAPES:
            nes += [1064, 1066, 60, 1]
        for ne in nes:
            BG, u, D = (rng.standard_normal(s) for s in
                        ((m * nq, nd), (nd, ne), (m * m, nq, ne)))
            for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
                args = [torch.as_tensor(a, dtype=dtype, device=cuda)
                        for a in (BG, u, D)]
                err, yk = _cuda_err(args)
                assert err <= tol, (m, nd, nq, ne, dtype, err)
                # no atomics: a second call gives the same bits
                assert torch.equal(kbtdb.btdb_apply(*args), yk)
                # on another stream than the default one
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    ys = kbtdb.btdb_apply(*args)
                side.synchronize()
                assert torch.equal(ys, yk), (m, nd, nq, ne, dtype)
                # u_eT at an address that is no multiple of 16 bytes
                shifted = torch.empty(u.size + 1, dtype=dtype,
                                      device=cuda)[1:].view(nd, ne)
                shifted.copy_(args[1])
                assert torch.equal(
                    kbtdb.btdb_apply(args[0], shifted, args[2]), yk)
    # ne = 0: nothing to launch on, an empty result
    for m, nd, nq in ((4, 64, 64), (4, 8, 8)):
        y0 = kbtdb.btdb_apply(torch.zeros((m * nq, nd), device=cuda),
                              torch.zeros((nd, 0), device=cuda),
                              torch.zeros((m * m, nq, 0), device=cuda))
        assert tuple(y0.shape) == (nd, 0)
    with pytest.raises(ValueError):  # (m, nd, nq) not instantiated
        kbtdb.btdb_apply(*[torch.zeros(s, device=cuda) for s in
                           ((4 * 8, 27), (27, 5), (16, 8, 5))])
    with pytest.raises(ValueError):  # not contiguous
        kbtdb.btdb_apply(torch.zeros((32, 8), device=cuda),
                         torch.zeros((5, 8), device=cuda).T,
                         torch.zeros((16, 8, 5), device=cuda))


@pytest.mark.gpu
def test_cuda_btdb_tiled_kernel_occupancy_and_packed_stream(cuda):
    """The tiled kernel keeps the blocks per SM its ring was sized for, and
    a stream packed ahead gives what packing in the call gives."""
    for nd in (27, 64, 125):
        assert kbtdb.tiled_blocks_per_sm(nd, 4) >= kbtdb.BLOCKS[4]
        assert kbtdb.tiled_blocks_per_sm(nd, 8) >= kbtdb.BLOCKS[8]
    rng = np.random.default_rng(2)
    BG, u, D = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=cuda)
                for s in ((256, 64), (64, 128), (16, 64, 128)))
    packed = kbtdb.pack_bg(BG, 4, 64)
    geo = kbtdb.tile_geometry(64, 64, 4)
    assert tuple(packed.shape) == (geo.TILES, kbtdb.KC, geo.NDP)
    assert torch.equal(kbtdb.btdb_apply(BG, u, D, packed),
                       kbtdb.btdb_apply(BG, u, D))
    with pytest.raises(ValueError, match="packed"):  # another order's stream
        kbtdb.btdb_apply(BG, u, D, kbtdb.pack_bg(
            torch.zeros((108, 27), device=cuda), 4, 27))
    # the one-thread-per-element shapes take BG as it is
    assert kbtdb.pack_bg(torch.zeros((32, 8), device=cuda), 4, 8) is None
