"""Port parity, ``motion.ale``: the three maps' ``map_point``, ``gradient``,
``cofactor``, ``jacobian_det`` and ``integrated_grid_flux`` at seeded random
reference points and times against the JAX ``AleMap``, float64, to 1e-14 of
the largest entry, on tensors and on numpy arrays alike (the numpy result is
numpy) and with ``t`` a 0-d tensor; the gradient against central finite
differences of the map; the cofactor as the adjugate; the flux divergence
against finite differences of the flux; boundary points stay on the
boundary; and ``parse_kind``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.motion.ale import AleMap as JAleMap

from cmfem_tpu_torch.motion.ale import AleMap, parse_kind

KINDS = ["identity", "accuracy_a", "accuracy_b"]


def _points(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (4, 7, 2)), rng.uniform(0.0, 2.0, 3)


def _close(t, j, tol=1e-14):
    j = np.asarray(j)
    t = t.numpy() if torch.is_tensor(t) else t
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=tol * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("array", ["tensor", "numpy"])
def test_maps_match_jax(kind, array):
    x, ts = _points()
    m, jm = AleMap(kind), JAleMap(kind)
    xt = torch.as_tensor(x) if array == "tensor" else x
    ok_type = torch.is_tensor if array == "tensor" \
        else (lambda a: isinstance(a, np.ndarray))
    xj = jnp.asarray(x)
    for t in ts:
        for name in ("map_point", "gradient", "cofactor", "jacobian_det"):
            out = getattr(m, name)(xt, float(t))
            assert ok_type(out), name
            _close(out, getattr(jm, name)(xj, float(t)))
        phi, div = m.integrated_grid_flux(xt, float(t), float(t) + 0.05)
        jphi, jdiv = jm.integrated_grid_flux(xj, float(t), float(t) + 0.05)
        assert ok_type(phi) and ok_type(div)
        _close(phi, jphi)
        _close(div, jdiv)


@pytest.mark.parametrize("kind", KINDS)
def test_time_as_a_tensor(kind):
    x, ts = _points(1)
    m = AleMap(kind)
    xt = torch.as_tensor(x)
    t = torch.tensor(ts[0], dtype=torch.float64)
    _close(m.gradient(xt, t), m.gradient(xt, float(ts[0])))
    phi, div = m.integrated_grid_flux(xt, t, t + 0.1)
    phi_f, div_f = m.integrated_grid_flux(xt, float(ts[0]),
                                          float(ts[0]) + 0.1)
    _close(phi, phi_f.numpy())
    _close(div, div_f.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_matches_fd(kind):
    m = AleMap(kind)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.1, 0.9, (5, 2)))
    t = 0.37
    G = m.gradient(x, t)
    eps = 1e-6
    for d in range(2):
        dx = torch.zeros((1, 2), dtype=torch.float64)
        dx[0, d] = eps
        fd = (m.map_point(x + dx, t) - m.map_point(x - dx, t)) / (2 * eps)
        _close(G[:, :, d], fd.numpy(), tol=1e-8)
    J = m.jacobian_det(x, t)
    _close(J, np.linalg.det(G.numpy()), tol=1e-12)
    # the reference's "cofactor" is the adjugate: C = J G^{-1}
    _close(m.cofactor(x, t), J.numpy()[:, None, None]
           * np.linalg.inv(G.numpy()), tol=1e-12)


@pytest.mark.parametrize("kind", ["accuracy_a", "accuracy_b"])
def test_integrated_flux_divergence_matches_fd(kind):
    m = AleMap(kind)
    x = torch.tensor([[0.3, 0.7], [0.6, 0.2]], dtype=torch.float64)
    t0, t1 = 0.1, 0.18
    _, div = m.integrated_grid_flux(x, t0, t1)
    eps = 1e-6
    div_fd = torch.zeros(2, dtype=torch.float64)
    for d in range(2):
        dx = torch.zeros((1, 2), dtype=torch.float64)
        dx[0, d] = eps
        pp, _ = m.integrated_grid_flux(x + dx, t0, t1)
        pm, _ = m.integrated_grid_flux(x - dx, t0, t1)
        div_fd += (pp[:, d] - pm[:, d]) / (2 * eps)
    _close(div, div_fd.numpy(), tol=1e-8)


def test_boundary_stays_on_boundary():
    xb = torch.tensor([[0.0, 0.3], [1.0, 0.8], [0.5, 0.0], [0.2, 1.0]],
                      dtype=torch.float64)
    _close(AleMap("accuracy_b").map_point(xb, 0.33), xb.numpy())
    mapped = AleMap("accuracy_a").map_point(xb, 0.33)
    assert abs(mapped[0, 0] - 0.0) < 1e-14 and abs(mapped[1, 0] - 1.0) < 1e-14
    assert abs(mapped[2, 1] - 0.0) < 1e-14 and abs(mapped[3, 1] - 1.0) < 1e-14


def test_parse_kind():
    assert parse_kind("id") == "identity"
    assert parse_kind("MAP_A") == "accuracy_a"
    assert parse_kind("map_b") == "accuracy_b"
    with pytest.raises(ValueError, match="ale_map must be"):
        parse_kind("bogus")
