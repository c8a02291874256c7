"""Port parity, the z-chain path (TPU kernel B4): cmfem_tpu_torch's
``SumFactoredOperator.bind_zchain`` and ``kernels.zchain`` against
cmfem_tpu's ``bind(use_pallas=True)`` on the same forms and numpy-seeded
vectors.

- (i) ``bind_zchain`` on the CPU against JAX's B4 run in Pallas interpret
  mode, on the two B4 cases of tests/test_partial.py ((4,4,4) p=2 with
  tile 72; (3,4,5) p=2 z-periodic with tile 54) and (3,4,5) p=3 with
  kappa = 0.1 + z^2 on full D with tile 64: atol 1e-13 max|y| in float64,
  for the port operator carried over from JAX's arrays
  (``from_arrays``) and for the port's own assembly;
- (ii) ``zchain_plain`` against the z stage written out here in numpy with
  the dense Az/DAz and the full symmetric 4x4 D blocks (1e-13 max|U|), and
  ``bind_zchain`` against ``bind()`` at orders 1-4 (1e-13 max|y|);
- (iii) the refusals, at bind time on any device: uncompressed D, the
  periodic bind on D that is not z-periodic, and q1 != p + 1.
The CUDA kernel runs only on the card: the tests marked ``gpu`` hold it
against the plain version there (float64 to 1e-12 max|U|; float32 to 1e-5
max|U|: each output sums <= 2 * 5 * 5 products in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_3d as j_mesh3d
from cmfem_tpu.ops import BilinearForm as JForm, SpaceOps as JSpaceOps
from cmfem_tpu.ops.assembly import OperatorData as JOperatorData
from cmfem_tpu.ops.sumfact import SumFactoredOperator as JSumFact

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
from cmfem_tpu_torch.interop import operator_data_from_numpy
from cmfem_tpu_torch.kernels import zchain as kz
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops.sumfact import (
    SumFactoredOperator,
    _axis_matrices,
    _lagrange_tab_1d,
)

BETA = np.array([1.0, -2.0, 0.5])
DT = 1e-2


def _form(form_cls, ops, kappa):
    if kappa == "z":
        return (form_cls(ops).add_mass(1.0).add_convection(BETA, alpha=DT)
                .add_diffusion(lambda x: DT * (0.1 + x[:, 2] ** 2)))
    return (form_cls(ops).add_diffusion(kappa).add_convection(BETA)
            .add_mass(1.0))


def _pair(n, order, kappa=0.3, quad_order=None):
    """(JAX operator, port operator) on the same form, float64."""
    q = 2 * order if quad_order is None else quad_order
    jops = JSpaceOps(JFESpace(j_mesh3d(*n), order), quad_order=q)
    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(*n), order), quad_order=q,
                   device="cpu")
    jop = JSumFact(jops, _form(JForm, jops, kappa).assemble(), *n, order,
                   dtype=jnp.float64)
    op = SumFactoredOperator(ops, _form(BilinearForm, ops, kappa).assemble(),
                             *n, order, device="cpu", dtype=torch.float64)
    return jop, op


def _carried(jop):
    """The port operator built from the JAX operator's own arrays."""
    axes = [np.asarray(M) for M in (jop.Ax, jop.DAx, jop.Ay, jop.DAy,
                                    jop.Az, jop.DAz)]
    return SumFactoredOperator.from_arrays(
        np.asarray(jop.D), None if jop.Dz is None else np.asarray(jop.Dz),
        axes, jop.n, jop.p, compressed=jop.compressed, periodic=jop.periodic,
        z_periodic=jop.z_periodic, device="cpu", dtype=torch.float64)


def _check(y, y_ref, tol=1e-13):
    y_ref = np.asarray(y_ref)
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(np.asarray(y) / scale, y_ref / scale,
                               atol=tol)


@pytest.mark.parametrize("n,order,kappa,periodic,tile", [
    ((4, 4, 4), 2, 0.3, False, 72),
    ((3, 4, 5), 2, 0.3, True, 54),
    ((3, 4, 5), 3, "z", False, 64),
])
def test_bind_zchain_matches_jax_b4_interpret(n, order, kappa, periodic,
                                              tile):
    jop, op = _pair(n, order, kappa)
    assert op.compressed and op.z_periodic == (kappa != "z")
    assert (op.Ky * op.Kx) % tile == 0
    u = np.random.default_rng(order).standard_normal(op.ndofs)
    jf, jD = jop.bind(use_pallas=True, tile=tile, interpret=True,
                      use_periodic=periodic)
    y_ref = jf(jnp.asarray(u), jD)
    for port in (op, _carried(jop)):
        fn, D = port.bind_zchain(use_periodic=periodic)
        assert tuple(D.shape) == tuple(jD.shape)
        np.testing.assert_allclose(D.numpy(), np.asarray(jD),
                                   atol=1e-14 * np.abs(np.asarray(jD)).max())
        _check(fn(torch.as_tensor(u), D).numpy(), y_ref)


def _zstage_reference(T0, Tx, Ty, D, Az, DAz, periodic):
    """The z stage in numpy: dense z contractions, the full symmetric
    4x4 block at every quadrature point, the transposed contractions."""
    Kz, KK = Az.shape[0], T0.shape[1]
    if periodic:
        D = np.tile(D, (1, Kz // D.shape[1], 1))
    d00, d0x, d0y, d0z, dxx, dxy, dxz, dyy, dyz, dzz = D
    zero = np.zeros((Kz, KK))
    blocks = np.array([[d00, d0x, d0y, d0z],
                       [zero, dxx, dxy, dxz],
                       [zero, dxy, dyy, dyz],
                       [zero, dxz, dyz, dzz]])  # (4, 4, Kz, KK)
    V = np.stack([Az @ T0, Az @ Tx, Az @ Ty, DAz @ T0])
    W = np.einsum("rsqc,sqc->rqc", blocks, V)
    return Az.T @ W[0] + DAz.T @ W[3], Az.T @ W[1], Az.T @ W[2]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_zchain_plain_matches_dense_z_stage(order, periodic):
    rng = np.random.default_rng(10 * order + periodic)
    nz, KK, q1 = 3, 7, order + 1
    Az, DAz = _axis_matrices(nz, order, q1)
    NZ = Az.shape[1]
    T = [rng.standard_normal((NZ, KK)) for _ in range(3)]
    D = rng.standard_normal((10, q1 if periodic else nz * q1, KK))
    ref = _zstage_reference(*T, D, Az, DAz, periodic)
    tab = torch.as_tensor(np.stack(_lagrange_tab_1d(order, q1)[:2]))
    args = [torch.as_tensor(a) for a in (*T, D)]
    outs = kz.zchain_plain(*args, torch.as_tensor(Az), torch.as_tensor(DAz),
                           periodic)
    before = kz.launches, kz.launches_periodic
    outs_w = kz.zchain_apply(*args, tab, torch.as_tensor(Az),
                             torch.as_tensor(DAz), periodic)
    assert (kz.launches, kz.launches_periodic) == before  # CPU: plain
    for U, Uw, U_ref in zip(outs, outs_w, ref):
        assert U.shape == (NZ, KK)
        _check(U.numpy(), U_ref)
        _check(Uw.numpy(), U_ref)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_bind_zchain_matches_bind(order):
    """Uniform D (full D and Dz) and kappa(z) D (full D)."""
    n = (2, 3, 2)
    u = torch.as_tensor(np.random.default_rng(order).standard_normal(
        (2 * order + 1) * (3 * order + 1) * (2 * order + 1)))
    for kappa in (0.3, "z"):
        _, op = _pair(n, order, kappa)
        fn, D = op.bind()
        y = fn(u, D).numpy()
        for periodic in (False, True) if op.z_periodic else (False,):
            fz, Dz = op.bind_zchain(use_periodic=periodic)
            _check(fz(u, Dz).numpy(), y)


def test_bind_zchain_refusals():
    # uncompressed D: d10 != 0, as SUPG's reaction term makes it
    rng = np.random.default_rng(2)
    jops = JSpaceOps(JFESpace(j_mesh3d(2, 3, 2), 2), quad_order=4)
    jdata = _form(JForm, jops, 0.3).assemble()
    d10 = 0.01 * rng.standard_normal(np.asarray(jdata.d01).shape)
    data = operator_data_from_numpy(np.asarray(jdata.d00),
                                    np.asarray(jdata.d01), d10,
                                    np.asarray(jdata.d11), device="cpu")
    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(2, 3, 2), 2),
                   quad_order=4, device="cpu")
    unc = SumFactoredOperator(ops, data, 2, 3, 2, 2, device="cpu",
                              dtype=torch.float64)
    assert not unc.compressed
    with pytest.raises(ValueError, match="requires compressed D"):
        unc.bind_zchain()
    junc = JSumFact(jops, JOperatorData(jdata.d00, jdata.d01,
                                        jnp.asarray(d10), jdata.d11),
                    2, 3, 2, 2, dtype=jnp.float64)
    with pytest.raises(ValueError, match="requires compressed D"):
        junc.bind(use_pallas=True, tile=12)
    # the periodic bind on D that varies along z
    jvop, vop = _pair((2, 3, 2), 2, "z")
    assert vop.compressed and not vop.z_periodic
    for bind in (lambda: vop.bind_zchain(use_periodic=True),
                 lambda: jvop.bind(use_pallas=True, tile=12,
                                   use_periodic=True)):
        with pytest.raises(ValueError, match="z-periodic compressed"):
            bind()
    vop.bind_zchain()  # full D is fine
    # q1 != p + 1 (quadrature of order 2p + 2): refused at bind time
    _, qop = _pair((2, 2, 2), 2, quad_order=6)
    assert qop.q1 == 4 and qop.compressed
    with pytest.raises(ValueError, match="q1 = p \\+ 1"):
        qop.bind_zchain()


def test_zchain_wrapper_refuses_other_devices():
    T = torch.zeros((5, 4), device="meta")
    D = torch.zeros((10, 6, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kz.zchain_apply(T, T, T, D, torch.zeros((2, 3, 3)), None, None,
                        False)


@pytest.mark.parametrize("KK,nz,chunks", [(20_736, 48, 6), (57_600, 48, 5),
                                          (300, 3, 1), (1000, 100, 12),
                                          (10**6, 100, 1)])
def test_z_chunks(KK, nz, chunks):
    """Enough chunks for about one full wave of threads on the card, none
    shorter than 8 z-elements."""
    assert kz.z_chunks(KK, nz) == chunks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_cuda_zchain_kernel_matches_plain(cuda, order):
    rng = np.random.default_rng(order)
    q1 = order + 1
    for nz, KK in ((3, 37), (17, 300), (48, 1000)):
        Az, DAz = _axis_matrices(nz, order, q1)
        NZ = Az.shape[1]
        tab = np.stack(_lagrange_tab_1d(order, q1)[:2])
        for periodic in (False, True):
            arrs = [rng.standard_normal((NZ, KK)) for _ in range(3)]
            arrs.append(rng.standard_normal(
                (10, q1 if periodic else nz * q1, KK)))
            for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
                t = [torch.as_tensor(a, dtype=dtype, device=cuda)
                     for a in (*arrs, tab, Az, DAz)]
                before = kz.launches, kz.launches_periodic
                outs = kz.zchain_apply(*t, periodic)
                assert (kz.launches, kz.launches_periodic) == (
                    before[0] + 1, before[1] + periodic)
                ref = kz.zchain_plain(*t[:4], *t[5:], periodic)
                torch.cuda.synchronize()
                for U, R in zip(outs, ref):
                    err = float((U - R).abs().max() / R.abs().max())
                    assert err <= tol, (nz, KK, periodic, dtype, err)


@pytest.mark.gpu
def test_cuda_bind_zchain_matches_bind(cuda):
    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(3, 4, 5), 3),
                   quad_order=6, device=cuda)
    op = SumFactoredOperator(ops, _form(BilinearForm, ops, "z").assemble(),
                             3, 4, 5, 3, device=cuda, dtype=torch.float64)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(op.ndofs),
                        device=cuda)
    fn, D = op.bind()
    fz, Dz = op.bind_zchain()
    y, yz = fn(u, D), fz(u, Dz)
    torch.cuda.synchronize()
    assert float((yz - y).abs().max() / y.abs().max()) <= 1e-12
    with pytest.raises(ValueError):  # T fields of the wrong dtype
        kz.zchain_apply(*(t.float() for t in op.xy_fields(u)), Dz, op.tab,
                        op.Az, op.DAz, False)
