"""Port parity, the ALE/GCL terms of ``physics/ablation.py`` and its case-2.2
methods: both packages' ``AblationSystem`` on a 3 x 12 graded triangle
strip (``torch_ablation_helpers.ablation_pair``: the synthetic TACOT deck,
a mid-heating state carried from the JAX package, the JAX geometric
factors, gravity on), float64 on the CPU.

With a seeded non-zero mesh velocity ``wq`` at the QPs and a seeded
(J_old, J_new) pair, under each of the 8 ``ale_toggles`` (one parametrised
test): the residual to 1e-12 and the AD element Jacobians to 1e-10
(relative to the largest entry), and ``jacobian_check`` passes in both
packages (< 1e-4).  The lumped top-boundary recession velocity (case-2.2
flux model, chemistry-blowing bc, both density modes) and the
mass-equation probes, host-located (``mass_eq_probe``) and by a
``TrackedSampler`` on receded vertices (``mass_eq_probe_scan``), at found
and not-found points (NaN rows in the same places), to 1e-12."""

import itertools

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    ablation_pair, rel, one_torch_thread)

TOGGLES = list(itertools.product((False, True), repeat=3))


@pytest.fixture(scope="module")
def ale(tmp_path_factory):
    """The triangle pair, a seeded mesh velocity at the QPs and a GCL pair
    (the JAX arrays and the port tensors)."""
    import jax.numpy as jnp

    pair = ablation_pair(tmp_path_factory.mktemp("strip"), 3, 12, 1,
                         geom="triangle")
    gf = pair["gf"]
    rng = np.random.default_rng(7)
    wq = 1e-3 * rng.standard_normal(tuple(gf.xq.shape))
    detJ = gf.detJ.numpy()
    J_old = detJ * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, detJ.shape))
    pair["j_ale"] = {"wq": jnp.asarray(wq),
                     "gcl": (jnp.asarray(J_old), jnp.asarray(detJ))}
    pair["p_ale"] = {"wq": torch.tensor(wq),
                     "gcl": (torch.tensor(J_old), gf.detJ)}
    return pair


def _jax_gf(pair):
    return pair["jsys"].ops.gf


@pytest.mark.parametrize("toggles", TOGGLES,
                         ids=["".join("1" if t else "0" for t in tg)
                              for tg in TOGGLES])
def test_ale_gcl_residual_and_jacobians_match_jax(ale, toggles):
    jsys, psys = ale["jsys"], ale["psys"]
    jkw = dict(gf=_jax_gf(ale), ale_toggles=toggles, **ale["j_ale"])
    pkw = dict(gf=ale["gf"], ale_toggles=toggles, **ale["p_ale"])
    RTj, Rpj = jsys.residual(*ale["jargs"], **jkw)
    RTp, Rpp = psys.residual(*ale["pargs"], **pkw)
    assert rel(RTj, RTp) < 1e-12 and rel(Rpj, Rpp) < 1e-12
    # the ALE and GCL terms are really in: the residual moves with them,
    # by far more than the two packages differ
    R = torch.cat([RTp, Rpp]).numpy()
    R0 = torch.cat(psys.residual(*ale["pargs"], gf=ale["gf"])).numpy()
    d_jax = np.abs(R - np.concatenate([np.asarray(RTj), np.asarray(Rpj)]))
    if any(toggles):
        assert np.abs(R - R0).max() > 1e3 * d_jax.max()
    bj = jsys.element_jacobians(*ale["jargs"], **jkw)
    bp = psys.element_jacobians(*ale["pargs"], **pkw)
    for a, b in zip(bj, bp):
        assert tuple(b.shape) == a.shape and rel(a, b) < 1e-10
    ej = jsys.jacobian_check(*ale["jargs"], **jkw)
    ep = psys.jacobian_check(*ale["pargs"], **pkw)
    assert 0.0 <= ej < 1e-4 and 0.0 <= ep < 1e-4, (ej, ep)


def _case22_flux(branch="chemistry_blowing"):
    """(JAX model, bc, table), (port model, bc, table): the case-2.2 flux
    model on the schedule fixture's heating state."""
    from cmfem_tpu.physics import bprime as JB, seb as JS, surface_bc as JBC
    from cmfem_tpu_torch.physics import bprime as PB, seb as PS, \
        surface_bc as PBC

    args = (101325.0, 0.3, 1.5e6, 10.0, 300.0, True, True, 1)
    out = []
    for S, BC, B in ((JS, JBC, JB), (PS, PBC, PB)):
        model, bc = S.SurfaceFluxModel(case22=True), BC.BoundaryState(*args)
        assert S.classify_branch(bc, model) == branch
        out.append((model, bc, B.BPrimeTable.synthetic_tacot()))
    return out


def _receded(xy, amount=2e-4):
    """Vertices moved down near the top, as a smoothed recession moves
    them."""
    v = np.asarray(xy, dtype=np.float64).copy()
    y0, y1 = v[:, 1].min(), v[:, 1].max()
    v[:, 1] -= amount * ((v[:, 1] - y0) / (y1 - y0)) ** 2
    return v


@pytest.mark.parametrize("mode", ["char_surface", "constant"])
def test_recession_velocity_matches_jax(ale, mode):
    import jax.numpy as jnp

    (jm, jbc, jb), (pm, pbc, pb) = _case22_flux()
    jsys, psys = ale["jsys"], ale["psys"]
    xy = np.asarray(ale["fes"].node_positions)
    T = ale["T"]
    p = 2.0e4 + 4.0e5 * (0.05 - xy[:, 1])       # gas leaving the top
    for verts in (None, _receded(ale["fes"].mesh.vertices)):
        a = np.asarray(jsys.top_boundary_recession_velocity(
            jnp.asarray(T), jnp.asarray(p), ale["jstate"], jbc,
            "chemistry_blowing", jm, jb, recession_density_mode=mode,
            recession_density_constant=1100.0,
            vertices=None if verts is None else jnp.asarray(verts)))
        b = psys.top_boundary_recession_velocity(
            torch.tensor(T), torch.tensor(p), ale["state"], pbc,
            "chemistry_blowing", pm, pb, recession_density_mode=mode,
            recession_density_constant=1100.0, vertices=verts)
        assert rel(a, b) < 1e-12
        top = np.unique(np.asarray(ale["fes"].boundary_dofs([3])))
        assert (a[top] > 0).all() and (a[np.setdiff1d(np.arange(len(a)),
                                                      top)] == 0).all()


def test_mass_eq_probe_host_and_scan_match_jax(ale):
    import jax.numpy as jnp

    from cmfem_tpu.core.tracksample import TrackedSampler as JSampler
    from cmfem_tpu_torch.core.tracksample import TrackedSampler

    jsys, psys = ale["jsys"], ale["psys"]
    mesh = ale["fes"].mesh
    T, p = ale["T"], ale["p"]
    # inside points, one above the receded top, one left of the strip
    pts = np.array([[0.00125, 0.0497], [0.0004, 0.046], [0.002, 0.03],
                    [0.001, 0.001], [0.00125, 0.05 + 1e-3],
                    [-1e-3, 0.02]])
    for verts in (np.asarray(mesh.vertices, dtype=np.float64),
                  _receded(mesh.vertices)):
        a = jsys.mass_eq_probe(jnp.asarray(T), jnp.asarray(p),
                               ale["jstate"], pts, vertices=verts)
        b = psys.mass_eq_probe(torch.tensor(T), torch.tensor(p),
                               ale["state"], pts, vertices=verts)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(a[4:]).all() and np.isfinite(a[:4]).all()
        assert rel(a[:4], b[:4]) < 1e-12
        js = JSampler(mesh, pts, y_slack=1e-3)
        ps = TrackedSampler(mesh, pts, y_slack=1e-3, device="cpu")
        jv, pv = jnp.asarray(verts), torch.tensor(verts)
        X = ale["jstate"].extent
        pi = np.asarray(ale["jstate"].pi_qp)
        c = np.asarray(jsys.mass_eq_probe_scan(
            jnp.asarray(T), jnp.asarray(p), jnp.asarray(X), jnp.asarray(pi),
            js, js.locate(jv), jv))
        d = psys.mass_eq_probe_scan(
            torch.tensor(T), torch.tensor(p), ale["state"].extent,
            torch.tensor(pi), ps, ps.locate(pv), pv).numpy()
        assert np.array_equal(np.isnan(c), np.isnan(d))
        assert rel(c[:4], d[:4]) < 1e-12
        # the scan form equals the host form (one P1 gradient per element)
        assert rel(b[:4], d[:4]) < 1e-10
