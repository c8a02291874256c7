"""Port parity, the TACOT material model (``physics/tacot.py``): the same
seeded inputs through both packages in float64 on the CPU.  Splines and the
(p, T) tables with their derivatives, in range, at both clamps and at an
exact interior pressure level, to 1e-13 (uniform, ragged and one-level
tables); the reaction extents and their IFT tangent against ``jax.jvp`` to
1e-12 (interior, clamped at x = 1 and inactive points); the port's
``vmap(jacfwd)`` through the extent ``Function`` against JAX's; the
extent sweeps' host early exit against their frozen device form, bit for
bit; the solid and gas properties to 1e-13; ``load_yaml`` of the JSON
fixture against ``from_mapping`` and against the JAX package's loader of
the same file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfem_tpu.physics import tacot as J
from cmfem_tpu_torch.physics import tacot as P

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "tacot_synthetic.json")
DT = 0.1


@pytest.fixture(scope="module")
def mats():
    return J.TacotMaterial.load_yaml(FIXTURE), P.TacotMaterial.load_yaml(FIXTURE)


@pytest.fixture(scope="module")
def mats_m0(tmp_path_factory):
    """The deck with a zeroth-order second reaction: its Newton step can
    overshoot x = 1, so the extent lands on the upper clamp (with m = 3 it
    never does)."""
    with open(FIXTURE) as f:
        root = json.load(f)
    root["reactions"][1]["m"] = 0.0
    path = str(tmp_path_factory.mktemp("deck") / "m0.json")
    with open(path, "w") as f:
        json.dump(root, f)
    return J.TacotMaterial.load_yaml(path), P.TacotMaterial.load_yaml(path)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(b) \
        else np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _queries(rng, shape=(6, 9)):
    """T over the knot range and beyond both clamps; p across the levels,
    both clamps and exactly on the interior level."""
    T = rng.uniform(100.0, 4200.0, shape)
    T.flat[:3] = (150.0, 200.0, 4000.0)
    p = rng.uniform(500.0, 2.0e6, shape)
    p.flat[:5] = (101325.0, 1.0e3, 1.0e6, 200.0, 3.0e6)
    return T, p


def test_spline_eval_matches_jax():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 10.0, 15))
    y = np.sin(x) + 0.1 * rng.standard_normal(15)
    y2 = P.natural_spline_y2(x, y)
    np.testing.assert_array_equal(y2, J.natural_spline_y2(x, y))
    xq = np.concatenate([rng.uniform(x[0] - 1, x[-1] + 1, 200),
                         [x[0], x[-1], x[3]]])
    for yy, yy2, q in ((y, y2, xq),
                       # batched coefficient sets aligned with the queries
                       (np.stack([y, 2 * y, -y]), np.stack([y2, 2 * y2, -y2]),
                        xq[:3])):
        vj, dj, cj = J.spline_eval(x, jnp.asarray(yy), jnp.asarray(yy2),
                                   jnp.asarray(q))
        vp, dp, cp = P.spline_eval(x, yy, yy2, torch.tensor(q))
        assert _rel(vj, vp) < 1e-13 and _rel(dj, dp) < 1e-13
        np.testing.assert_array_equal(np.asarray(cj), cp.numpy())


@pytest.mark.parametrize("table", ["virgin", "char", "gas"])
def test_eval_props_with_derivatives_matches_jax(mats, table):
    mj, mp = mats
    T, p = _queries(np.random.default_rng(1))
    outs_j = getattr(mj, table).eval_props((0, 1, 2), p, T, with_derivs=True)
    outs_p = getattr(mp, table).eval_props((0, 1, 2), torch.tensor(p),
                                           torch.tensor(T), with_derivs=True)
    for oj, op in zip(outs_j, outs_p):
        for a, b in zip(oj[:3], op[:3]):            # value, dp, dT
            assert _rel(a, b) < 1e-13
        for a, b in zip(oj[3:], op[3:]):            # the clamp flags
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    vals = getattr(mp, table).eval_props((2, 0), torch.tensor(p),
                                         torch.tensor(T))
    for a, b in zip(getattr(mj, table).eval_props((2, 0), p, T), vals):
        assert _rel(a, b) < 1e-13


@pytest.mark.parametrize("levels", [
    # ragged: per-level T grids of different counts and positions
    [{"p": 1.0e3, "rows": [[300.0, 1.0], [600.0, 2.0], [900.0, 2.5],
                           [1500.0, 4.0]]},
     {"p": 1.0e5, "rows": [[400.0, 10.0], [800.0, 12.0], [1600.0, 15.0],
                           [2400.0, 16.0], [3200.0, 18.0]]},
     {"p": 1.0e6, "rows": [[350.0, 11.0], [700.0, 13.0], [1800.0, 14.0]]}],
    # one pressure level
    [{"p": 1.0e5, "rows": [[300.0, 1.0], [600.0, 2.0], [900.0, 2.5],
                           [1500.0, 4.0]]}],
])
def test_ragged_and_single_level_tables_match_jax(levels):
    node = {"pressure_tables": levels}
    tj = J.PropertyTable.from_yaml_node(node, 1)
    tp = P.PropertyTable.from_yaml_node(node, 1)
    assert tj.uniform == tp.uniform
    rng = np.random.default_rng(2)
    T = rng.uniform(100.0, 3500.0, 40)
    T[:4] = (300.0, 1500.0, 3200.0, 250.0)
    p = rng.uniform(500.0, 2.0e6, 40)
    p[:3] = (1.0e5, 1.0e3, 1.0e6)
    oj = tj.eval(0, p, T, with_derivs=True)
    op = tp.eval(0, torch.tensor(p), torch.tensor(T), with_derivs=True)
    for a, b in zip(oj[:3], op[:3]):
        assert _rel(a, b) < 1e-13
    for a, b in zip(oj[3:], op[3:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _extent_inputs(seed=3):
    """Interior points, points clamped at x = 1 (hot, nearly spent) and
    inactive ones (below both thresholds)."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(300.0, 1500.0, (5, 8))
    X0 = rng.uniform(0.0, 0.6, (5, 8, 2))
    T[0, :4] = 320.0                      # inactive
    T[1, :4], X0[1, :4] = 2500.0, 0.999   # onto x = 1 if zeroth order
    return T, X0


@pytest.mark.parametrize("deck", ["fixture", "m0"])
def test_extent_solve_and_tangent_match_jax(mats, mats_m0, deck):
    mj, mp = mats if deck == "fixture" else mats_m0
    T, X0 = _extent_inputs()
    xj = mj.solve_reaction_extents(T, DT, X0)
    xp = mp.solve_reaction_extents(torch.tensor(T), DT, torch.tensor(X0))
    assert _rel(xj, xp) < 1e-12
    assert (xp.numpy() == X0).any()                       # inactive points
    assert (xp.numpy() == 1.0).any() == (deck == "m0")    # the x = 1 clamp
    rng = np.random.default_rng(4)
    tT, tX = rng.standard_normal(T.shape), rng.standard_normal(X0.shape)
    tdt = 0.3
    _, jt = jax.jvp(lambda T, dt, X: mj.solve_reaction_extents(T, dt, X),
                    (jnp.asarray(T), jnp.asarray(DT), jnp.asarray(X0)),
                    (jnp.asarray(tT), jnp.asarray(tdt), jnp.asarray(tX)))
    _, pt = torch.func.jvp(
        lambda T, dt, X: mp.solve_reaction_extents(T, dt, X),
        (torch.tensor(T), torch.tensor(DT, dtype=torch.float64),
         torch.tensor(X0)),
        (torch.tensor(tT), torch.tensor(tdt, dtype=torch.float64),
         torch.tensor(tX)))
    assert _rel(jt, pt) < 1e-12


def _sweep_batch(kind):
    """Extent-solve inputs (T, X0, dt) that stop the sweeps three ways:
    converged ("converging"), at the 30-sweep cap ("cap": so long a step
    that 1 - x shrinks by about a third a sweep, 50-odd sweeps from x = 0),
    and on a NaN change ("nan": a NaN temperature, and a NaN old extent at
    an active point)."""
    T, X0 = _extent_inputs()
    dt = DT
    if kind == "cap":
        T[:], X0[:], dt = 3000.0, 0.0, 1e25
    elif kind == "nan":
        T[2, 0] = np.nan
        T[2, 1], X0[2, 1, 1] = 1200.0, np.nan
    return T, X0, dt


@pytest.mark.parametrize("batch", ["converging", "cap", "nan"])
def test_extent_sweeps_frozen_equal_early_exit(mats, batch):
    """The extent sweeps with the host's early exit and with the device
    flag that freezes x (what a CUDA graph capture runs) give the same x
    bit for bit; the eager loop's waits, one a sweep, show where it
    stopped."""
    from cmfem_tpu_torch.utils.timing import StepTimer

    _, mp = mats
    T, X0, dt = _sweep_batch(batch)
    T = torch.tensor(T)
    x_old = torch.clamp(torch.tensor(X0), 0.0, 1.0)
    dtb = torch.tensor(dt, dtype=torch.float64)
    rt = P._Rates(mp, T)
    Tc, arr, tpow, _, _ = rt.pieces(T, x_old)
    active = rt.active(Tc, arr, dtb)
    timer = StepTimer()
    out = {}
    for frozen in (False, True):
        with timer.span("sweeps"):
            out[frozen] = P._extent_sweeps(rt, T, dtb, x_old, arr, tpow,
                                           active, mp.newton_iters, frozen)
        out["waits", frozen] = timer.step_reset().get("host_syncs", 0)
    assert torch.equal(out[False].view(torch.int64),
                       out[True].view(torch.int64))
    assert out["waits", True] == 0
    sweeps = {"converging": range(2, mp.newton_iters), "cap":
              [mp.newton_iters], "nan": [1]}[batch]
    assert out["waits", False] in sweeps and mp.newton_iters == 30
    assert torch.isnan(out[True]).any() == (batch == "nan")


def _composite(mat):
    """A scalar QP field that runs every material path: extents, solid and
    gas properties at the new and the old state."""
    def f(T, p, X):
        s = mat.solid_props(T, p, mat.solve_reaction_extents(T, DT, X),
                            extent_old=X, dt=DT)
        g = mat.gas_props(T, p)
        so = mat.solid_props(T, p, X)
        return (s["cp"] * s["rho_s"] * T + g["rho"] * g["h"]
                + 1e3 * s["pi_total"] + s["k"] * so["K"] * 1e9
                + s["pyrolysis_heat_sink"] + g["mu"] * 1e6)
    return f


@pytest.mark.parametrize("deck", ["fixture", "m0"])
def test_vmap_jacfwd_through_the_extent_function_matches_jax(mats, mats_m0,
                                                             deck):
    mj, mp = mats if deck == "fixture" else mats_m0
    T, X0 = _extent_inputs(5)
    p = np.random.default_rng(6).uniform(9.0e4, 1.2e5, T.shape)
    Jj = jax.vmap(jax.jacfwd(_composite(mj), argnums=(0, 1)))(
        jnp.asarray(T), jnp.asarray(p), jnp.asarray(X0))
    Jp = torch.func.vmap(torch.func.jacfwd(_composite(mp),
                                           argnums=(0, 1)))(
        torch.tensor(T), torch.tensor(p), torch.tensor(X0))
    for a, b in zip(Jj, Jp):
        assert b.shape == a.shape and _rel(a, b) < 1e-12


def test_solid_and_gas_props_match_jax(mats):
    mj, mp = mats
    T, p = _queries(np.random.default_rng(7), (4, 6))
    rng = np.random.default_rng(8)
    X0 = rng.uniform(0.0, 0.5, (4, 6, 2))
    X = np.clip(X0 + rng.uniform(0.0, 0.4, X0.shape), 0.0, 1.0)
    sj = mj.solid_props(T, p, X, extent_old=X0, dt=DT)
    sp = mp.solid_props(torch.tensor(T), torch.tensor(p), torch.tensor(X),
                        extent_old=torch.tensor(X0), dt=DT)
    assert set(sj) == set(sp)
    for k in sj:
        assert _rel(sj[k], sp[k]) < 1e-13, k
    s0j, s0p = mj.solid_props(T, p, X), mp.solid_props(
        torch.tensor(T), torch.tensor(p), torch.tensor(X))
    for k in s0j:
        assert _rel(s0j[k], s0p[k]) < 1e-13, k
    gj = mj.gas_props(T, p)
    gp = mp.gas_props(torch.tensor(T), torch.tensor(p))
    for k in gj:
        assert _rel(gj[k], gp[k]) < 1e-13, k
    assert mp.rho_virgin == mj.rho_virgin and mp.rho_char == mj.rho_char


def test_load_json_equals_from_mapping_and_the_jax_loader(mats):
    mj, mp = mats
    with open(FIXTURE) as f:
        mm = P.TacotMaterial.from_mapping(json.load(f))
    for m in (mm, mj):
        for k in ("R", "min_pi_pyro", "K_v", "K_c", "eps_g_v", "eps_g_c"):
            assert getattr(m, k) == getattr(mp, k)
        for k in ("rho_eps0", "F", "A", "E", "m_exp", "n_exp", "T_thr",
                  "h_reac", "phase"):
            np.testing.assert_array_equal(getattr(m, k), getattr(mp, k))
        for tab in ("virgin", "char", "gas"):
            for k in ("p_levels", "T_tab", "T_hi", "y", "y2"):
                np.testing.assert_array_equal(getattr(getattr(m, tab), k),
                                              getattr(getattr(mp, tab), k))
    assert mp.num_reactions == 2 and list(mp.phase) == [1, 1]
    assert mp.virgin_optics is None


@pytest.mark.gpu
def test_cuda_extent_function_under_vmap_jacfwd_equals_cpu(mats):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, mp = mats
    T, X0 = _extent_inputs(9)
    p = np.random.default_rng(10).uniform(9.0e4, 1.2e5, T.shape)
    f = torch.func.vmap(torch.func.jacfwd(_composite(mp),
                                          argnums=(0, 1)))
    ref = f(torch.tensor(T), torch.tensor(p), torch.tensor(X0))
    dev = torch.device("cuda")
    out = f(torch.tensor(T, device=dev), torch.tensor(p, device=dev),
            torch.tensor(X0, device=dev))
    for a, b in zip(ref, out):
        assert _rel(a.numpy(), b) < 1e-12
