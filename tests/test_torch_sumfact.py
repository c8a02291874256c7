"""Port parity, sum-factorized operator: cmfem_tpu_torch.ops.sumfact against
cmfem_tpu.ops.sumfact on the same assembled forms and numpy-seeded vectors.

On the CPU the port's plain chains (``bind()``, ``_bind_periodic``) are
held against JAX's ``bind()`` and against the TPU kernel B2
(``bind(use_fused=True, z_fma=True, interpret=True)``, Pallas interpret
mode, as tests/test_partial.py runs it), to atol 1e-13 max|y| in float64.
The CUDA kernel itself runs only on the card: the tests marked ``gpu`` hold
it against the plain version there (float64 to 1e-12 max|y|; float32 to
1e-5 max|y|, sums taken in another order, <= 125 terms per output)."""

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
from cmfem_tpu_torch.kernels import sumfact as ksum
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops.sumfact import SumFactoredOperator

BETA = np.array([1.0, -2.0, 0.5])
CASES = [((3, 4, 5), 1), ((3, 4, 5), 2), ((3, 4, 5), 3),
         ((2, 3, 4), 1), ((2, 3, 4), 2), ((2, 3, 4), 3)]


def _forms(n, order, mass=1.0):
    nx, ny, nz = n
    jops = JSpaceOps(JFESpace(j_mesh3d(nx, ny, nz), order),
                     quad_order=2 * order)
    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(nx, ny, nz), order),
                   quad_order=2 * order, device="cpu")
    jm, m = mass if isinstance(mass, tuple) else (mass, mass)
    jdata = (JForm(jops).add_diffusion(0.3).add_convection(BETA)
             .add_mass(jm).assemble())
    data = (BilinearForm(ops).add_diffusion(0.3).add_convection(BETA)
            .add_mass(m).assemble())
    return jops, jdata, ops, data


def _pair(n, order, dtype=torch.float64, mass=1.0):
    jops, jdata, ops, data = _forms(n, order, mass)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jop = JSumFact(jops, jdata, *n, order, dtype=jdt)
    op = SumFactoredOperator(ops, data, *n, order, device="cpu", dtype=dtype)
    return jop, op


def _flags(op):
    return op.compressed, op.periodic, op.z_periodic


def _check(y, y_ref, tol=1e-13):
    y_ref = np.asarray(y_ref)
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y.numpy() / scale, y_ref / scale, atol=tol)


@pytest.mark.parametrize("n,order", CASES)
def test_plain_chains_match_jax_and_b2(n, order):
    jop, op = _pair(n, order)
    assert _flags(op) == _flags(jop) == (True, True, True)
    scale = np.abs(np.asarray(jop.D)).max()
    np.testing.assert_allclose(op.D.numpy() / scale,
                               np.asarray(jop.D) / scale, atol=1e-14)
    np.testing.assert_allclose(op.Dz.numpy() / scale,
                               np.asarray(jop.Dz) / scale, atol=1e-14)
    u = np.random.default_rng(order).standard_normal(op.ndofs)
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    jfn, jD = jop.bind()
    y_ref = jfn(uj, jD)
    fn, D = op.bind()
    _check(fn(ut, D), y_ref)
    fnp, Dp = op.bind(use_periodic=True)
    _check(fnp(ut, Dp), y_ref)
    # the TPU kernel B2, z-periodic and full D, in interpret mode
    for periodic, (f, Df) in ((True, (fnp, Dp)), (False, (fn, D))):
        jf, jDf = jop.bind(use_fused=True, z_fma=True, use_periodic=periodic,
                           interpret=True)
        _check(f(ut, Df), jf(uj, jDf))


@pytest.mark.parametrize("coord,flags", [(0, (True, False, True)),
                                         (2, (True, False, False))])
def test_flags_match_jax_for_varying_coefficients(coord, flags):
    """A mass coefficient varying along x keeps the operator z-periodic;
    varying along z makes it neither periodic nor z-periodic."""
    mass = (lambda x: 1.0 + x[:, coord], lambda x: 1.0 + x[:, coord])
    jop, op = _pair((2, 3, 4), 2, mass=mass)
    assert _flags(op) == _flags(jop) == flags
    u = np.random.default_rng(1).standard_normal(op.ndofs)
    jfn, jD = jop.bind()
    fn, D = op.bind()
    _check(fn(torch.as_tensor(u), D), jfn(jnp.asarray(u), jD))
    if op.z_periodic:
        fnp, Dp = op.bind(use_periodic=True)
        _check(fnp(torch.as_tensor(u), Dp), jfn(jnp.asarray(u), jD))
    else:
        with pytest.raises(ValueError):
            op.bind(use_periodic=True)
        with pytest.raises(ValueError):
            op.bind_kernel(use_periodic=True)


def test_uncompressed_generic_chain_matches_jax():
    """d10 != 0 (as SUPG's reaction term makes it) forces the 16-plane
    generic chain; the kernel refuses such an operator."""
    jops, jdata, ops, _ = _forms((2, 3, 2), 2)
    rng = np.random.default_rng(2)
    d10 = 0.01 * rng.standard_normal(np.asarray(jdata.d01).shape)
    jdata = JOperatorData(jdata.d00, jdata.d01, jnp.asarray(d10), jdata.d11)
    data = operator_data_from_numpy(np.asarray(jdata.d00),
                                    np.asarray(jdata.d01), d10,
                                    np.asarray(jdata.d11), device="cpu")
    jop = JSumFact(jops, jdata, 2, 3, 2, 2, dtype=jnp.float64)
    op = SumFactoredOperator(ops, data, 2, 3, 2, 2, device="cpu",
                             dtype=torch.float64)
    assert _flags(op) == _flags(jop)
    assert not op.compressed and op.D.shape[0] == 16
    u = rng.standard_normal(op.ndofs)
    jfn, jD = jop.bind()
    fn, D = op.bind()
    _check(fn(torch.as_tensor(u), D), jfn(jnp.asarray(u), jD))
    assert not op.kernel_eligible
    with pytest.raises(ValueError):
        op.bind_kernel()
    assert op.best_bind()[2] == "plain-chain"


@pytest.mark.parametrize("order", [1, 2])
def test_float32_flags_match_jax(order):
    jop, op = _pair((3, 4, 5), order, dtype=torch.float32)
    assert _flags(op) == _flags(jop)
    assert op.D.dtype == torch.float32 and op.Dz.dtype == torch.float32
    u = np.random.default_rng(0).standard_normal(op.ndofs).astype(np.float32)
    jfn, jD = jop.bind()
    fn, D = op.bind(use_periodic=True)
    _check(fn(torch.as_tensor(u), D), jfn(jnp.asarray(u), jD), tol=1e-5)


@pytest.mark.parametrize("order", [1, 3])
def test_from_arrays_carries_jax_operator(order):
    jop, op = _pair((2, 3, 4), order)
    axes = [np.asarray(M) for M in (jop.Ax, jop.DAx, jop.Ay, jop.DAy,
                                    jop.Az, jop.DAz)]
    op2 = SumFactoredOperator.from_arrays(
        np.asarray(jop.D), np.asarray(jop.Dz), axes, jop.n, jop.p,
        compressed=jop.compressed, periodic=jop.periodic,
        z_periodic=jop.z_periodic, device="cpu", dtype=torch.float64)
    assert _flags(op2) == _flags(jop)
    _eq = np.testing.assert_array_equal
    _eq(op2.tab.numpy(), op.tab.numpy())
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(op.ndofs))
    for periodic in (False, True):
        f2, D2 = op2.bind(use_periodic=periodic)
        f, D = op.bind(use_periodic=periodic)
        _check(f2(u, D2), f(u, D).numpy())


def test_best_bind_and_wrapper_on_cpu_use_the_plain_version():
    _, op = _pair((2, 3, 4), 2)
    fn, D, path = op.best_bind()
    assert path == "plain-chain" and D is op.D
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(op.ndofs))
    before = ksum.launches
    for periodic in (False, True):
        fk, Dk = op.bind_kernel(use_periodic=periodic)
        _check(fk(u, Dk), fn(u, D).numpy())
    assert ksum.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="unsupported device"):
        ksum.sumfact_apply(u.to("meta"), op.D.to("meta"), op.tab,
                           op._mats, False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,order", [((3, 4, 5), 1), ((3, 4, 5), 2),
                                     ((2, 3, 4), 3), ((2, 2, 3), 4)])
def test_cuda_kernel_matches_plain(cuda, n, order):
    jops, jdata, ops, data = _forms(n, order)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        op = SumFactoredOperator(ops, data, *n, order, device=cuda,
                                 dtype=dtype)
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(
            op.ndofs), dtype=dtype, device=cuda)
        for periodic in (True, False):
            before = ksum.launches
            fk, Dk = op.bind_kernel(use_periodic=periodic)
            yk = fk(u, Dk)
            assert ksum.launches == before + 1
            fp, Dp = op.bind(use_periodic=periodic)
            yp = fp(u, Dp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max() / yp.abs().max())
            assert err <= tol, (dtype, periodic, err)
        assert op.best_bind()[2] == "cuda-sumfact-zperiodic"


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    _, _, ops, data = _forms((2, 2, 2), 2)
    op = SumFactoredOperator(ops, data, 2, 2, 2, 2, device=cuda)
    u = torch.zeros(op.ndofs, device=cuda)
    with pytest.raises(ValueError):  # dtype mismatch with D
        ksum.sumfact_apply(u.double(), op.Dz, op.tab, op._mats, True)
    with pytest.raises(ValueError):  # full D passed as z-periodic
        ksum.sumfact_apply(u, op.D, op.tab, op._mats, True)
    with pytest.raises(ValueError):  # not contiguous
        ksum.sumfact_apply(torch.zeros(2 * op.ndofs, device=cuda)[::2],
                           op.Dz, op.tab, op._mats, True)
    with pytest.raises(TypeError):
        ksum.sumfact_apply(u.half(), op.Dz.half(), op.tab.half(), op._mats,
                           True)
