"""Port parity, ``ops.vector``: ``VectorBilinearForm`` (elasticity with
variable Lame parameters, vector diffusion) ``assemble``, ``apply`` (on the
port's C and on the JAX package's C carried over by
``interop.vector_qp_from_numpy``), ``assemble_diagonal``, ``vector_domain_lf``
and ``vector_boundary_lf`` against the JAX functions in 2D (quads, moved
vertices; triangles) and 3D (hexes), float64 on the CPU, to 1e-12 of the
largest entry; and the port's own checks: rigid-body modes lie in the
elasticity kernel, the operator is symmetric, vector diffusion is the scalar
diffusion per component, and the diagonal is the operator's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace
from cmfem_tpu.core import (
    make_cartesian_mesh_2d as j_mesh2d,
    make_cartesian_mesh_3d as j_mesh3d,
)
from cmfem_tpu.ops import SpaceOps as JSpaceOps
from cmfem_tpu.ops import vector as jvec

from cmfem_tpu_torch.core import (
    FESpace, make_cartesian_mesh_2d, make_cartesian_mesh_3d,
)
from cmfem_tpu_torch.interop import vector_qp_from_numpy
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops import vector as tvec

CASES = [("quad", 2), ("triangle", 1), ("hex", 2), ("hex", 1)]


def _pair(kind, order):
    if kind == "hex":
        jm, m = j_mesh3d(2, 2, 3), make_cartesian_mesh_3d(2, 2, 3)
    else:
        jm, m = j_mesh2d(3, 4, geom=kind), make_cartesian_mesh_2d(3, 4,
                                                                   geom=kind)
    if kind != "triangle":
        rng = np.random.default_rng(3)
        v = m.vertices + 0.02 * rng.standard_normal(m.vertices.shape)
        jm, m = jm.with_vertices(v), m.with_vertices(v)
    dim = m.dim
    return (JSpaceOps(JFESpace(jm, order, vdim=dim)),
            SpaceOps(FESpace(m, order, vdim=dim), device="cpu"), dim)


def lam_fn(x):
    return 2.0 + x[:, 0] * x[:, 1]


def load(x):
    """(npts, dim) for numpy and tensors alike."""
    return 1.0 + x * x[:, :1] - 0.5 * x[:, -1:] ** 2


def _close(t, j):
    j = np.asarray(j)
    assert t.dtype == torch.float64 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(j).max()))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{k}-p{p}" for k, p in CASES])
def forms(request):
    jops, ops, dim = _pair(*request.param)
    jf = (jvec.VectorBilinearForm(jops).add_elasticity(lam_fn, 1.5)
          .add_vector_diffusion(0.3))
    tf = (tvec.VectorBilinearForm(ops).add_elasticity(lam_fn, 1.5)
          .add_vector_diffusion(0.3))
    return jf, tf, jops, ops, dim


def test_assemble_matches_jax(forms):
    jf, tf, *_ = forms
    C = tf.assemble()
    assert C.ndim == 6
    _close(C, jf.assemble())


def test_apply_matches_jax_also_on_jax_C(forms):
    jf, tf, jops, ops, dim = forms
    u = np.random.default_rng(0).standard_normal(dim * ops.fes.nscalar)
    jC = jf.assemble()
    y_ref = jf.apply(jC, jnp.asarray(u))
    _close(tf.apply(tf.assemble(), torch.as_tensor(u)), y_ref)
    C_from_jax = vector_qp_from_numpy(np.asarray(jC), device="cpu")
    _close(tf.apply(C_from_jax, torch.as_tensor(u)), y_ref)


def test_assemble_diagonal_matches_jax_and_operator(forms):
    jf, tf, jops, ops, dim = forms
    C = tf.assemble()
    d = tf.assemble_diagonal(C)
    _close(d, jf.assemble_diagonal(jf.assemble()))
    # the diagonal of the operator it belongs to, by unit vectors
    N = dim * ops.fes.nscalar
    for i in np.random.default_rng(1).choice(N, 4, replace=False):
        e = torch.zeros(N, dtype=torch.float64)
        e[i] = 1.0
        assert abs(float(tf.apply(C, e)[i] - d[i])) < 1e-12 * float(d.abs().max())


def test_vector_domain_lf_matches_jax(forms):
    _, _, jops, ops, dim = forms
    _close(tvec.vector_domain_lf(ops, load, vdim=dim),
           jvec.vector_domain_lf(jops, load, vdim=dim))
    # with a time argument
    ft = lambda x, t: t * load(x)
    _close(tvec.vector_domain_lf(ops, ft, time=0.7),
           jvec.vector_domain_lf(jops, ft, time=0.7))


@pytest.mark.parametrize("marker", [None, [2]])
def test_vector_boundary_lf_matches_jax(forms, marker):
    _, _, jops, ops, dim = forms
    _close(tvec.vector_boundary_lf(ops, load, attr_marker=marker, vdim=dim),
           jvec.vector_boundary_lf(jops, load, attr_marker=marker, vdim=dim))


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_modes_in_kernel_and_symmetry(dim):
    m = make_cartesian_mesh_2d(3, 3) if dim == 2 \
        else make_cartesian_mesh_3d(2, 2, 2)
    fes = FESpace(m, 2, vdim=dim)
    ops = SpaceOps(fes, device="cpu")
    vf = tvec.VectorBilinearForm(ops).add_elasticity(lam=2.0, mu=1.0)
    C = vf.assemble()
    n = fes.nscalar
    x = torch.as_tensor(fes.node_positions)
    modes = []
    for c in range(dim):  # translations
        u = torch.zeros((dim, n), dtype=torch.float64)
        u[c] = 1.0
        modes.append(u)
    for a, b in ((0, 1), (0, 2), (1, 2))[:1 if dim == 2 else 3]:
        u = torch.zeros((dim, n), dtype=torch.float64)  # rotation in (a, b)
        u[a], u[b] = -x[:, b], x[:, a]
        modes.append(u)
    for u in modes:
        assert vf.apply(C, u.reshape(-1)).abs().max() < 1e-10
    rng = np.random.default_rng(1)
    a, b = (torch.as_tensor(rng.standard_normal(dim * n)) for _ in range(2))
    lhs, rhs = float(b @ vf.apply(C, a)), float(a @ vf.apply(C, b))
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_vector_diffusion_is_componentwise_scalar():
    fes = FESpace(make_cartesian_mesh_2d(3, 3), 2, vdim=2)
    ops = SpaceOps(fes, device="cpu")
    vf = tvec.VectorBilinearForm(ops).add_vector_diffusion(0.7)
    sf = BilinearForm(ops).add_diffusion(0.7)
    sd = sf.assemble()
    n = fes.nscalar
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(2 * n))
    y = vf.apply(vf.assemble(), u)
    torch.testing.assert_close(
        y, torch.cat([sf.apply(sd, u[:n]), sf.apply(sd, u[n:])]), rtol=0,
        atol=1e-11)


def test_vector_qp_from_numpy_refuses_other_shapes():
    with pytest.raises(ValueError, match="ne, nq, v, d, v, d"):
        vector_qp_from_numpy(np.zeros((2, 3, 2, 2)), device="cpu")


def test_dof_slots_scatter_equals_index_add():
    """The fixed-order scatter sums what ``index_add_`` sums (valences 1 to
    4 on quads), and the padding slot adds nothing."""
    fes = FESpace(make_cartesian_mesh_2d(3, 2), 2)
    ops = SpaceOps(fes, device="cpu")
    slots = tvec.dof_slots(ops.eldofs, fes.nscalar)
    assert tuple(slots.shape) == (fes.nscalar, 4)
    assert (slots == ops.eldofs.numel()).any(dim=1).sum() > 0
    y_e = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (*ops.eldofs.shape, 3)))
    ref = torch.zeros((3, fes.nscalar), dtype=torch.float64)
    for c in range(3):
        ref[c].index_add_(0, ops.eldofs.reshape(-1), y_e[..., c].reshape(-1))
    torch.testing.assert_close(tvec._scatter_components(y_e, slots),
                               ref.reshape(-1), rtol=0, atol=1e-14)
