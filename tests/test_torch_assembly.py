"""Port parity, assembly layer: cmfem_tpu_torch.ops.{assembly, bc, partial}
against cmfem_tpu.ops on the same meshes and numpy-seeded vectors.

apply and assemble_diagonal of tests/test_partial.py::_setup's form match
to rtol/atol 1e-12 in float64 (same algebra, other summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, make_cartesian_mesh_3d as j_mesh3d
from cmfem_tpu.ops import (
    BilinearForm as JForm,
    EssentialBC as JBC,
    SpaceOps as JSpaceOps,
)
from cmfem_tpu.ops.partial import pack_qp_blocks_T as j_pack

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
from cmfem_tpu_torch.interop import operator_data_from_numpy
from cmfem_tpu_torch.ops import BilinearForm, EssentialBC, SpaceOps
from cmfem_tpu_torch.ops.partial import pack_qp_blocks_T

BETA = np.array([1.0, -2.0, 0.5])
TOL = dict(rtol=1e-12, atol=1e-12)


def _setup_pair(n=3, order=2, mesh_kw=None):
    """tests/test_partial.py::_setup's form, in both packages."""
    mesh_kw = mesh_kw or {}
    jfes = JFESpace(j_mesh3d(n, n, n, **mesh_kw), order)
    jops = JSpaceOps(jfes, quad_order=2 * order)
    jform = (JForm(jops).add_diffusion(0.3).add_convection(BETA)
             .add_mass(1.0))
    fes = FESpace(make_cartesian_mesh_3d(n, n, n, **mesh_kw), order)
    ops = SpaceOps(fes, quad_order=2 * order, device="cpu")
    form = (BilinearForm(ops).add_diffusion(0.3).add_convection(BETA)
            .add_mass(1.0))
    return jops, jform, jform.assemble(), ops, form, form.assemble()


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_apply_and_diagonal_match(order):
    jops, jform, jdata, ops, form, data = _setup_pair(3, order)
    for f in ("d00", "d01", "d11"):
        _close(getattr(data, f), getattr(jdata, f))
    assert data.d10 is None and jdata.d10 is None
    rng = np.random.default_rng(order)
    u = rng.standard_normal(ops.fes.nscalar)
    _close(form.apply(data, torch.as_tensor(u)),
           jform.apply(jdata, jnp.asarray(u)))
    _close(form.assemble_diagonal(data), jform.assemble_diagonal(jdata))


def test_callable_coefficients_and_stretched_mesh_match():
    kw = dict(sx=2.0, sy=0.5, sz=1.5)
    jfes = JFESpace(j_mesh3d(2, 3, 2, **kw), 2)
    jops = JSpaceOps(jfes, quad_order=4)
    fes = FESpace(make_cartesian_mesh_3d(2, 3, 2, **kw), 2)
    ops = SpaceOps(fes, quad_order=4, device="cpu")
    jform = (JForm(jops).add_mass(lambda x: 1.0 + x[:, 0] * x[:, 2])
             .add_diffusion(lambda x: 0.1 + x[:, 1] ** 2)
             .add_convection(lambda x: jnp.stack(
                 [x[:, 1], -x[:, 0], 0.5 + 0 * x[:, 2]], axis=1)))
    form = (BilinearForm(ops).add_mass(lambda x: 1.0 + x[:, 0] * x[:, 2])
            .add_diffusion(lambda x: 0.1 + x[:, 1] ** 2)
            .add_convection(lambda x: torch.stack(
                [x[:, 1], -x[:, 0], 0.5 + 0 * x[:, 2]], dim=1)))
    jdata, data = jform.assemble(), form.assemble()
    u = np.random.default_rng(5).standard_normal(fes.nscalar)
    _close(form.apply(data, torch.as_tensor(u)),
           jform.apply(jdata, jnp.asarray(u)))
    _close(form.assemble_diagonal(data), jform.assemble_diagonal(jdata))


def test_operator_data_from_numpy_carries_jax_data():
    jops, jform, jdata, ops, form, _ = _setup_pair(2, 2)
    data = operator_data_from_numpy(
        np.asarray(jdata.d00), np.asarray(jdata.d01), None,
        np.asarray(jdata.d11), device="cpu")
    u = np.random.default_rng(7).standard_normal(ops.fes.nscalar)
    _close(form.apply(data, torch.as_tensor(u)),
           jform.apply(jdata, jnp.asarray(u)))


@pytest.mark.parametrize("order", [1, 2])
def test_pack_qp_blocks_match(order):
    jops, _, jdata, ops, _, data = _setup_pair(2, order)
    perm = np.random.default_rng(0).permutation(ops.B.shape[1])
    jD, jBG = j_pack(jops, jdata, jnp.float64, local_perm=perm)
    D, BG = pack_qp_blocks_T(ops, data, torch.float64, local_perm=perm)
    _close(D, jD)
    _close(BG, jBG, rtol=0, atol=0)
    D32, _ = pack_qp_blocks_T(ops, data)
    assert D32.dtype == torch.float32


def test_essential_bc_match():
    jops, jform, jdata, ops, form, data = _setup_pair(3, 2)
    ess = ops.fes.boundary_dofs([1, 4])
    n = ops.fes.nscalar
    jbc, bc = JBC(n, ess), EssentialBC(n, ess, device="cpu")
    rng = np.random.default_rng(11)
    x, b, ubc = (rng.standard_normal(n) for _ in range(3))
    jA = jbc.constrain_operator(lambda v: jform.apply(jdata, v))
    A = bc.constrain_operator(lambda v: form.apply(data, v))
    _close(A(torch.as_tensor(x)), jA(jnp.asarray(x)))
    _close(bc.constrained_rhs(lambda v: form.apply(data, v),
                              torch.as_tensor(b), torch.as_tensor(ubc)),
           jbc.constrained_rhs(lambda v: jform.apply(jdata, v),
                               jnp.asarray(b), jnp.asarray(ubc)))
    _close(bc.apply_values(torch.as_tensor(x), torch.as_tensor(ubc)),
           jbc.apply_values(jnp.asarray(x), jnp.asarray(ubc)), rtol=0, atol=0)
    _close(bc.zero_essential(torch.as_tensor(x)),
           jbc.zero_essential(jnp.asarray(x)), rtol=0, atol=0)
