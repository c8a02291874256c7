"""Port parity, ``ops.nonlinear.NonlinearForm``: ``residual``, ``jvp``,
``linearize``, ``element_jacobians`` (one aux mapped over the elements, one
broadcast), ``jacobian_diagonal`` and ``dense_jacobian`` of the port against
the JAX form on the same numpy-seeded inputs, quads at order 2 (vertices
moved, so that no factor is constant) and triangles at order 3, float64 on
the CPU, to 1e-12 of the largest entry; and the port's AD Jacobian against
central finite differences to 5e-8 (the twin of
``tests/test_apps.py::test_nonlinear_ad_jacobian_vs_fd``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace
from cmfem_tpu.core import make_cartesian_mesh_2d as j_mesh2d
from cmfem_tpu.ops import SpaceOps as JSpaceOps
from cmfem_tpu.ops.nonlinear import NonlinearForm as JForm

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d
from cmfem_tpu_torch.ops import SpaceOps
from cmfem_tpu_torch.ops.nonlinear import NonlinearForm

CASES = [("quad", 2), ("triangle", 3)]


def qp_residual(uq, gq, xq, u_old_q=None, k=None):
    """Written for both array modules: operators and indexing only."""
    m = 1.0 + 0.1 * uq
    a = k[0] + k[1] * uq + 0.2 * uq * uq
    r0 = m * (uq - u_old_q) + xq[..., 0] * uq ** 3
    r1 = a[..., None] * gq + 0.1 * xq * uq[..., None]
    return r0, r1


def _pair(geom, order):
    jmesh = j_mesh2d(3, 4, geom=geom)
    mesh = make_cartesian_mesh_2d(3, 4, geom=geom)
    if geom == "quad":
        rng = np.random.default_rng(7)
        v = mesh.vertices + 0.03 * rng.standard_normal(mesh.vertices.shape)
        jmesh, mesh = jmesh.with_vertices(v), mesh.with_vertices(v)
    jops = JSpaceOps(JFESpace(jmesh, order))
    ops = SpaceOps(FESpace(mesh, order), device="cpu")
    return jops, ops


def _inputs(jops, ops, seed=1):
    """(u, v, aux) as numpy, and the two packages' aux."""
    rng = np.random.default_rng(seed)
    n = ops.fes.nscalar
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    u_old_q = np.array(jops.values_at_qp(jnp.asarray(rng.standard_normal(n))))
    k = np.array([2.0, 0.05])  # (2,): not the element count, so broadcast
    jaux = {"u_old_q": jnp.asarray(u_old_q), "k": jnp.asarray(k)}
    taux = {"u_old_q": torch.as_tensor(u_old_q), "k": torch.as_tensor(k)}
    return u, v, jaux, taux


def _close(t, j):
    j = np.asarray(j)
    assert t.dtype == torch.float64 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(j).max()))


@pytest.fixture(scope="module", params=CASES, ids=[f"{g}-p{p}" for g, p in CASES])
def forms(request):
    jops, ops = _pair(*request.param)
    return JForm(jops, qp_residual), NonlinearForm(ops, qp_residual), jops, ops


def test_residual_matches_jax(forms):
    jf, tf, jops, ops = forms
    u, _, jaux, taux = _inputs(jops, ops)
    _close(tf.residual(torch.as_tensor(u), **taux),
           jf.residual(jnp.asarray(u), **jaux))


def test_jvp_matches_jax(forms):
    jf, tf, jops, ops = forms
    u, v, jaux, taux = _inputs(jops, ops)
    _close(tf.jvp(torch.as_tensor(u), torch.as_tensor(v), **taux),
           jf.jvp(jnp.asarray(u), jnp.asarray(v), **jaux))


def test_linearize_matches_jax(forms):
    jf, tf, jops, ops = forms
    u, v, jaux, taux = _inputs(jops, ops)
    Rj, fj = jf.linearize(jnp.asarray(u), **jaux)
    Rt, ft = tf.linearize(torch.as_tensor(u), **taux)
    _close(Rt, Rj)
    _close(ft(torch.as_tensor(v)), fj(jnp.asarray(v)))
    # the same linearization serves a second tangent
    _close(ft(torch.as_tensor(u)), fj(jnp.asarray(u)))


def test_element_jacobians_match_jax(forms):
    jf, tf, jops, ops = forms
    u, _, jaux, taux = _inputs(jops, ops)
    Je = tf.element_jacobians(torch.as_tensor(u), **taux)
    nd = ops.B.shape[1]
    assert tuple(Je.shape) == (ops.eldofs.shape[0], nd, nd)
    _close(Je, jf.element_jacobians(jnp.asarray(u), **jaux))


def test_jacobian_diagonal_matches_jax(forms):
    jf, tf, jops, ops = forms
    u, _, jaux, taux = _inputs(jops, ops)
    _close(tf.jacobian_diagonal(torch.as_tensor(u), **taux),
           jf.jacobian_diagonal(jnp.asarray(u), **jaux))


def test_dense_jacobian_matches_jax_and_jvp(forms):
    jf, tf, jops, ops = forms
    u, v, jaux, taux = _inputs(jops, ops)
    A = tf.dense_jacobian(torch.as_tensor(u), **taux)
    _close(A, jf.dense_jacobian(jnp.asarray(u), **jaux))
    # the assembled Jacobian is the one the JVP applies
    jv = tf.jvp(torch.as_tensor(u), torch.as_tensor(v), **taux)
    np.testing.assert_allclose((A @ torch.as_tensor(v)).numpy(), jv.numpy(),
                               rtol=0, atol=1e-12 * jv.abs().max().item())


def test_ad_jacobian_vs_fd():
    """The port's AD Jacobian against central differences of its residual
    (tests/test_apps.py::test_nonlinear_ad_jacobian_vs_fd, 2 x 2 quads,
    order 2)."""
    fes = FESpace(make_cartesian_mesh_2d(2, 2), 2)
    ops = SpaceOps(fes, device="cpu")

    def qp(uq, gq, xq, u_old_q=None):
        mcoef = 1.0 + 0.1 * uq
        acoef = 2.0 + 0.05 * uq
        return mcoef * (uq - u_old_q), acoef[..., None] * gq

    nlf = NonlinearForm(ops, qp)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(fes.nscalar))
    u_old_q = ops.values_at_qp(torch.as_tensor(
        rng.standard_normal(fes.nscalar)))
    J = nlf.dense_jacobian(u, u_old_q=u_old_q).numpy()
    eps = 1e-6
    for j in rng.choice(fes.nscalar, 5, replace=False):
        du = torch.zeros(fes.nscalar, dtype=torch.float64)
        du[j] = eps
        Rp = nlf.residual(u + du, u_old_q=u_old_q).numpy()
        Rm = nlf.residual(u - du, u_old_q=u_old_q).numpy()
        np.testing.assert_allclose(J[:, j], (Rp - Rm) / (2 * eps), atol=5e-8)


def test_r1_only_form_and_no_aux():
    """A pure-diffusion residual (r0 None) with no aux: the element Jacobian
    is the stiffness, so the AD Jacobian is symmetric and its rows sum to 0."""
    fes = FESpace(make_cartesian_mesh_2d(3, 3, geom="triangle"), 2)
    ops = SpaceOps(fes, device="cpu")
    nlf = NonlinearForm(ops, lambda uq, gq, xq: (None, gq))
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(fes.nscalar))
    A = nlf.dense_jacobian(u)
    torch.testing.assert_close(A, A.T, rtol=0, atol=1e-12)
    assert A.sum(dim=1).abs().max() < 1e-12
    torch.testing.assert_close(nlf.residual(u), A @ u, rtol=0, atol=1e-12)
