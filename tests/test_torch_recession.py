"""Port parity, the case-2.2 mesh motion: ``apps.common``'s switch
composition, ``motion.recession``, ``motion.remap`` and
``core.tracksample`` against the JAX package's on the CPU, float64 unless
stated.

- ``moving_mesh_and_ale_toggles`` over all 128 combinations of its seven
  keys (one parametrised test) and its refusal of another smoothing model.
- ``MeshRecessionHandler``: a uniform top velocity gives the linear
  Laplace profile and exact bookkeeping; the clamp by max_step_recession
  and non-negativity; a quality-guard failure raises in the JAX words and
  leaves the handler on its pre-step mesh; ``restore`` and its guard.
  Vertices and velocities equal JAX's to 1e-12.
- ``remap_extents_ale``: identity on a static mesh, downward advection on
  quads and triangles, donors bitwise equal to JAX's.
- ``StructuredStripRemap`` and ``TriStripRemap``: identity at zero
  velocity, vertical motion (donors bitwise equal to JAX's), the margin,
  the refusal of horizontal motion, a degenerate float32 cell staying
  finite.
- ``TrackedSampler`` on a graded triangle strip, static and receded,
  against JAX's sampler and the port's host ``pointlocate``: locations
  bitwise, samples to 1e-13, front depths to 1e-12; the first crossing
  of ``front_depth_from_samples``.
"""

import itertools

import numpy as np
import pytest
import torch

TOGGLE_KEYS = ("moving_mesh", "recession_enabled", "ale_enabled",
               "ale_energy_enabled", "ale_mass_enabled",
               "ale_energy_solid_enabled", "ale_energy_gas_enabled")
COMBOS = list(itertools.product((True, False), repeat=len(TOGGLE_KEYS)))


@pytest.mark.parametrize("combo", COMBOS, ids=[
    "".join("1" if v else "0" for v in c) for c in COMBOS])
def test_toggle_composition_matches_jax(combo):
    from cmfem_tpu.apps.common import moving_mesh_and_ale_toggles as J
    from cmfem_tpu_torch.apps.common import moving_mesh_and_ale_toggles as P

    cfg = dict(zip(TOGGLE_KEYS, combo))
    assert P(cfg) == J(cfg)
    moving, (mass, solid, gas) = P(cfg)
    assert moving == (cfg["moving_mesh"] and cfg["recession_enabled"])
    assert solid == (moving and cfg["ale_enabled"]
                     and cfg["ale_energy_enabled"]
                     and cfg["ale_energy_solid_enabled"])


def test_toggle_smoothing_model_is_validated():
    from cmfem_tpu.apps.common import moving_mesh_and_ale_toggles as J
    from cmfem_tpu_torch.apps.common import moving_mesh_and_ale_toggles as P

    assert P({"mesh_smoothing_model": "Laplacian"}) == (True,
                                                         (True, True, True))
    msgs = []
    for f in (J, P):
        with pytest.raises(ValueError, match="laplacian") as e:
            f({"mesh_smoothing_model": "elastic"})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _handlers(nx, ny, sy=1.0, **kw):
    from cmfem_tpu.core import FESpace as JF, make_cartesian_mesh_2d as jmesh
    from cmfem_tpu.motion.recession import MeshRecessionHandler as JH
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu_torch.motion.recession import MeshRecessionHandler

    jm, pm = jmesh(nx, ny, sy=sy), make_cartesian_mesh_2d(nx, ny, sy=sy)
    jfes, pfes = JF(jm, 1), FESpace(pm, 1)
    return (JH(jm, jfes, bdr_attr_top=3, bdr_attr_bottom=1, **kw),
            MeshRecessionHandler(pm, pfes, bdr_attr_top=3,
                                 bdr_attr_bottom=1, device="cpu", **kw),
            pfes)


def test_handler_uniform_top_velocity():
    jh, ph, fes = _handlers(4, 8)
    v_top = np.zeros(fes.nscalar)
    v_top[np.asarray(fes.boundary_dofs([3]))] = 2.0e-3
    ph.prepare_advance(torch.tensor(v_top), 0.1)
    jh.prepare_advance(v_top, 0.1)
    pts = fes.node_positions
    np.testing.assert_allclose(ph.mesh_velocity[:, 0], 0.0, atol=1e-10)
    np.testing.assert_allclose(ph.mesh_velocity[:, 1], -2.0e-3 * pts[:, 1],
                               atol=1e-8)
    np.testing.assert_allclose(ph.mesh_velocity, jh.mesh_velocity, rtol=0,
                               atol=1e-12 * 2.0e-3)
    out, jout = ph.commit_advance(), jh.commit_advance()
    assert abs(out["delta_recession"] - 2.0e-4) < 1e-12
    assert out.keys() == jout.keys()
    for k in out:
        assert abs(out[k] - jout[k]) <= 1e-12 * max(abs(jout[k]), 1e-300)
    np.testing.assert_allclose(ph.vertices, jh.vertices, rtol=0, atol=1e-12)
    top = np.asarray(fes.boundary_dofs([3]))
    np.testing.assert_allclose(ph.vertices[top, 1], 1.0 - 2.0e-4,
                               atol=1e-10)
    assert out["min_quality"] > 0.99
    qp = ph.mesh_velocity_at_qp(_ops(fes))
    assert torch.is_tensor(qp) and tuple(qp.shape)[-1] == 2


def _ops(fes):
    from cmfem_tpu_torch.ops import SpaceOps

    return SpaceOps(fes, quad_order=4, device="cpu")


def test_handler_clamp():
    jh, ph, fes = _handlers(2, 4, max_step_recession=1e-4)
    v_top = np.zeros(fes.nscalar)
    v_top[np.asarray(fes.boundary_dofs([3]))] = 100.0      # huge
    for h in (jh, ph):
        h.prepare_advance(v_top, 0.1)
        # clamped to max_step/dt = 1e-3
        assert abs(h._pending_mean_v - 1e-3) < 1e-12
        h.commit_advance()
    np.testing.assert_allclose(ph.vertices, jh.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ph.clamp_top_velocity(v_top, 0.1),
                                  jh.clamp_top_velocity(v_top, 0.1))
    v_top[:] = -5.0                        # negative velocities are zeroed
    v_top[0] = np.nan
    ph.prepare_advance(v_top, 0.1)
    assert ph._pending_mean_v == 0.0 and not ph.mesh_velocity.any()


def test_quality_guard_leaves_the_handler_consistent():
    jh, ph, fes = _handlers(2, 5, sy=0.01, min_quality_ratio=0.5)
    v_top = np.zeros(fes.nscalar)
    v_top[np.asarray(fes.boundary_dofs([3]))] = 0.06   # 60% of the height
    before = ph.vertices.copy()
    msgs = []
    for h in (jh, ph):
        h.prepare_advance(v_top, 0.1)
        with pytest.raises(RuntimeError, match="quality") as e:
            h.commit_advance()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    np.testing.assert_array_equal(ph.vertices, before)
    assert ph.total_recession == 0.0
    assert ph._pending_dt == 0.0 and ph._pending_mean_v == 0.0


def test_restore_and_its_guard():
    jh, ph, fes = _handlers(3, 6, min_quality_ratio=0.5)
    moved = ph.vertices.copy()
    moved[:, 1] *= 0.9
    for h in (jh, ph):
        h.restore(moved, 0.1)
    np.testing.assert_allclose(ph.vertices, jh.vertices, rtol=0, atol=1e-12)
    assert ph.total_recession == jh.total_recession == 0.1
    crushed = moved.copy()
    crushed[:, 1] *= 0.3
    for h in (jh, ph):
        with pytest.raises(RuntimeError, match="quality guard"):
            h.restore(crushed, 0.2)
    with pytest.raises(ValueError, match="vertex shape"):
        ph.restore(moved[:-1], 0.1)


def _remap_pair(nx, ny, geom):
    from cmfem_tpu.core import FESpace as JF, make_cartesian_mesh_2d as jmesh
    from cmfem_tpu.ops import SpaceOps as JOps
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d

    jm = jmesh(nx, ny, geom=geom)
    pm = make_cartesian_mesh_2d(nx, ny, geom=geom)
    return jm, JOps(JF(jm, 1), quad_order=4), pm, _ops(FESpace(pm, 1))


@pytest.mark.parametrize("geom", ["quad", "triangle"])
def test_remap_extents_ale_matches_jax(geom):
    from cmfem_tpu.motion.remap import remap_extents_ale as J
    from cmfem_tpu_torch.motion.remap import remap_extents_ale as P

    jm, jops, pm, pops = _remap_pair(2, 10, geom)
    ne, nq = tuple(pops.gf.wdetJ.shape)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (ne, nq, 2))
    w = np.zeros((ne, nq, 2))
    # identity on a static mesh
    out = P(pm, pops, torch.tensor(X), torch.tensor(w), 0.1, pm.vertices)
    np.testing.assert_array_equal(out, X)
    # mesh moving down: QPs adopt extents from the material above (here
    # extent = y), with the generic locator's stragglers
    yq = pops.gf.xq[..., 1].numpy()
    X = np.repeat(yq[..., None], 2, axis=-1)
    w[..., 1] = -0.05
    a = J(jm, jops, X, w, 1.0, jm.vertices)
    b = P(pm, pops, torch.tensor(X), torch.tensor(w), 1.0, pm.vertices)
    np.testing.assert_array_equal(a, b)           # donors bitwise
    interior = (yq > 0.1) & (yq < 0.9)
    assert np.abs(b[..., 0] - (yq - 0.05))[interior].max() < 0.06
    assert not np.array_equal(b, X)


def _moving_case(rm, pops, amount):
    """Seeded extents, vertices moved down near the top (vertical only),
    and a vertical mesh velocity whose step reaches ``amount``."""
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 1, (rm.ne, rm.nq, 3))
    yq = pops.gf.xq[..., 1].numpy()
    wq = np.zeros((rm.ne, rm.nq, 2))
    wq[..., 1] = -amount / 0.1 * yq
    return X, wq


@pytest.mark.parametrize("geom", ["quad", "triangle"])
def test_scan_remaps_match_jax(geom):
    import jax.numpy as jnp

    from cmfem_tpu.motion.remap import make_scan_remap as J
    from cmfem_tpu_torch.motion.remap import (
        StructuredStripRemap, TriStripRemap, make_scan_remap as P)

    jm, jops, pm, pops = _remap_pair(3, 8, geom)
    jr, pr = J(jm, jops), P(pm, pops)
    assert isinstance(pr, StructuredStripRemap if geom == "quad"
                      else TriStripRemap)
    verts = pm.vertices.astype(np.float64)
    xq = pops.gf.xq
    # identity at zero velocity: each QP is its own donor
    X, wq = _moving_case(pr, pops, 0.0)
    out = pr(torch.tensor(X), torch.tensor(verts), xq, torch.tensor(wq), 0.1)
    np.testing.assert_array_equal(out.numpy(), X)
    # vertical motion: within the margin on triangles (donors stay in
    # their element), a few QP spacings on the quad lattice
    amount = 0.5 * pr.margin() if geom == "triangle" else 0.2
    X, wq = _moving_case(pr, pops, amount)
    a = np.asarray(jr(jnp.asarray(X), jnp.asarray(verts),
                      jnp.asarray(xq.numpy()), jnp.asarray(wq), 0.1))
    b = pr(torch.tensor(X), torch.tensor(verts), xq, torch.tensor(wq),
           0.1).numpy()
    np.testing.assert_array_equal(a, b)
    if geom == "triangle":
        assert pr.margin() == jr.margin() > 0
        for e in (0, pr.ne // 2, pr.ne - 1):
            rows = {tuple(r) for r in X[e]}
            assert all(tuple(r) in rows for r in b[e])
    else:
        assert not np.array_equal(b, X)
        wq[..., 0] = 1e-3                  # horizontal motion is refused
        msgs = []
        for f, arr in ((jr, jnp.asarray), (pr, torch.tensor)):
            with pytest.raises(ValueError, match="vertical-only") as e:
                f(arr(X), arr(verts), arr(xq.numpy()), arr(wq), 0.1)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_structured_remap_degenerate_cell_f32_finite():
    """A fully collapsed lattice cell (yhi == ylo) gives no inf/nan donors
    in float32: the inverse map's guard is the runtime dtype's tiny."""
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu_torch.motion.remap import StructuredStripRemap

    m = make_cartesian_mesh_2d(2, 6)
    ops = _ops(FESpace(m, 1))
    rm = StructuredStripRemap(m, ops)
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.uniform(0, 1, (rm.ne, rm.nq, 3)),
                     dtype=torch.float32)
    verts = np.asarray(m.vertices).copy()
    ytop = verts[:, 1].max()
    verts[verts[:, 1] == ytop, 1] = np.unique(verts[:, 1])[-2]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    out = rm(X, f32(verts), f32(ops.gf.xq.numpy()),
             torch.zeros((rm.ne, rm.nq, 2)), 0.1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_make_scan_remap_refuses_other_geometries():
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
    from cmfem_tpu_torch.motion.remap import TriStripRemap, make_scan_remap

    m = make_cartesian_mesh_3d(1, 1, 1)
    ops = _ops(FESpace(m, 1))
    with pytest.raises(NotImplementedError, match="scan remap"):
        make_scan_remap(m, ops)
    with pytest.raises(NotImplementedError, match="triangles"):
        TriStripRemap(m, ops)


@pytest.fixture(scope="module")
def tri_strip():
    from cmfem_tpu_torch.core import FESpace, make_strip_mesh_2d

    mesh = make_strip_mesh_2d(4, 30, geom="triangle")
    return mesh, FESpace(mesh, 1)


def _receded(mesh, amount=8e-4):
    """Vertices moved down near the top, like smoothed recession."""
    v = np.asarray(mesh.vertices, dtype=np.float64).copy()
    y0, y1 = v[:, 1].min(), v[:, 1].max()
    v[:, 1] -= amount * np.clip((v[:, 1] - y0) / (y1 - y0), 0.0, 1.0) ** 2
    return v


def test_tracked_sampler_matches_jax_and_host(tri_strip):
    import jax.numpy as jnp

    from cmfem_tpu.core.tracksample import TrackedSampler as JSampler
    from cmfem_tpu_torch.core.pointlocate import (
        locate_points, sample_h1, sample_h1_grad, sample_l2)
    from cmfem_tpu_torch.core.tracksample import TrackedSampler

    mesh, fes = tri_strip
    rng = np.random.default_rng(0)
    v = np.asarray(mesh.vertices)
    lo, hi = v.min(axis=0), v.max(axis=0)
    pts = np.column_stack([rng.uniform(lo[0], hi[0], 40),
                           rng.uniform(lo[1], hi[1], 40)])
    # points outside (above the top, beside the strip), the probe column,
    # a vertex and the bottom edge
    pts = np.vstack([pts, [[0.00125, hi[1] + 1e-3]], [[-1e-3, 0.02]],
                     [[0.00125, 0.046]], v[7:8], [[0.00125, 0.0]]])
    js = JSampler(mesh, pts, y_slack=2e-3)
    ps = TrackedSampler(mesh, pts, y_slack=2e-3, device="cpu")
    assert (ps.npts, ps.npairs) == (js.npts, js.npairs)
    n = fes.nscalar
    u = np.sin(300.0 * fes.node_positions[:, 0]) \
        + 40.0 * fes.node_positions[:, 1] ** 2
    tau = rng.uniform(0, 1, mesh.num_elements)
    for verts in (v.astype(np.float64), _receded(mesh)):
        jloc = js.locate(jnp.asarray(verts))
        loc = ps.locate(torch.tensor(verts))
        e_host, r_host = locate_points(mesh, pts, vertices=verts)
        np.testing.assert_array_equal(loc[0].numpy(), np.asarray(jloc[0]))
        np.testing.assert_array_equal(loc[0].numpy(), e_host)
        np.testing.assert_array_equal(loc[2].numpy(), e_host >= 0)
        np.testing.assert_array_equal(loc[1].numpy(), np.asarray(jloc[1]))
        assert loc[0].dtype == torch.int32
        assert not loc[2][40:42].any() and loc[2][42:].all()
        f = e_host >= 0
        vals = ps.sample_h1(loc, torch.tensor(u)).numpy()
        host = sample_h1(fes, u, pts, vertices=verts)
        assert np.array_equal(np.isnan(vals), np.isnan(host))
        assert np.abs(vals[f] - host[f]).max() <= 1e-13 * np.abs(host[f]).max()
        np.testing.assert_allclose(vals, np.asarray(js.sample_h1(
            jloc, jnp.asarray(u))), rtol=1e-13)
        g = ps.sample_grad(loc, torch.tensor(u), torch.tensor(verts)).numpy()
        gh = sample_h1_grad(fes, u, pts, vertices=verts)
        assert np.array_equal(np.isnan(g), np.isnan(gh))
        assert np.abs(g[f] - gh[f]).max() <= 1e-13 * np.abs(gh[f]).max()
        l2 = ps.sample_l2(loc, torch.tensor(tau)).numpy()
        np.testing.assert_array_equal(l2, sample_l2(mesh, tau, pts,
                                                    vertices=verts))
    assert n == len(u)


def test_front_depth_from_samples_matches_host(tri_strip):
    import jax.numpy as jnp

    from cmfem_tpu.core.tracksample import (
        TrackedSampler as JSampler, front_depth_from_samples as jfront)
    from cmfem_tpu_torch.core.pointlocate import front_depth
    from cmfem_tpu_torch.core.tracksample import (
        TrackedSampler, front_depth_from_samples, line_points)

    mesh, fes = tri_strip
    v0 = np.asarray(mesh.vertices)
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    xmid = 0.5 * (lo[0] + hi[0])
    line = line_points(xmid, hi[1], lo[1])
    ps = TrackedSampler(mesh, line, y_slack=2e-3, device="cpu")
    js = JSampler(mesh, line, y_slack=2e-3)
    yc = v0[mesh.elem_conn].mean(axis=1)[:, 1]
    # tau rises with depth (a charred top), with a second crossing below
    tau = np.clip((hi[1] - yc) / 0.01, 0.0, 1.0)
    tau[yc < 0.01] = 0.5
    for verts in (v0.astype(np.float64), _receded(mesh)):
        top = float(verts[:, 1].max())
        lv = ps.sample_l2(ps.locate(torch.tensor(verts)), torch.tensor(tau))
        jlv = js.sample_l2(js.locate(jnp.asarray(verts)), jnp.asarray(tau))
        for thr in (0.98, 0.02, 0.5):
            got = float(front_depth_from_samples(
                lv, torch.tensor(line[:, 1]), top, thr))
            ref = float(jfront(jlv, jnp.asarray(line[:, 1]), top, thr))
            host = front_depth(mesh, tau, xmid, hi[1], lo[1], thr,
                               vertices=verts)
            assert abs(got - ref) <= 1e-12 * max(abs(ref), 1e-300)
            if top == hi[1]:                   # the same line: the host's
                assert abs(got - host) <= 1e-12 * max(abs(host), 1e-300)
            assert (got > 0.0) == (thr != 0.02)
    # no crossing gives 0, and the FIRST crossing is the one taken
    flat = torch.full((11,), 0.3, dtype=torch.float64)
    ys = torch.linspace(1.0, 0.0, 11, dtype=torch.float64)
    assert float(front_depth_from_samples(flat, ys, 1.0, 0.5)) == 0.0
    two = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
                        0.0], dtype=torch.float64)
    assert abs(float(front_depth_from_samples(two, ys, 1.0, 0.5))
               - 0.15) < 1e-12


def test_tracked_sampler_refuses_quads():
    from cmfem_tpu.core import make_cartesian_mesh_2d as jmesh
    from cmfem_tpu.core.tracksample import TrackedSampler as JSampler
    from cmfem_tpu_torch.core import make_cartesian_mesh_2d
    from cmfem_tpu_torch.core.tracksample import TrackedSampler

    msgs = []
    for make in (lambda: JSampler(jmesh(2, 2), [[0.5, 0.5]]),
                 lambda: TrackedSampler(make_cartesian_mesh_2d(2, 2),
                                        [[0.5, 0.5]], device="cpu")):
        with pytest.raises(NotImplementedError, match="triangle") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_strip_mesh_triangles_split_as_the_cartesian_mesh():
    from cmfem_tpu_torch.core import (make_cartesian_mesh_2d,
                                      make_strip_mesh_2d)

    q = make_strip_mesh_2d(3, 5)
    t = make_strip_mesh_2d(3, 5, geom="triangle")
    c = make_cartesian_mesh_2d(3, 5, sx=0.0025, sy=0.05, geom="triangle")
    assert t.geom == "triangle" and t.num_elements == 2 * q.num_elements
    np.testing.assert_array_equal(t.vertices, q.vertices)
    np.testing.assert_array_equal(t.elem_conn, c.elem_conn)
    np.testing.assert_array_equal(t.bdr_attr, q.bdr_attr)
