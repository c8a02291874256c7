"""Port parity, ``physics/seb.py`` and ``physics/surface_bc.py``: the flux
branches, the blowing correction and its fixed points (values and
``jacfwd`` in the wall mass flux, also at m_dot_g_w = 0, where
``max(raw, 0)`` sits on its tie), and the surface fluxes on every branch
with ``case22`` off and on, against the JAX package to 1e-13, float64 on
the CPU; the schedules: 5- and 7-column files, the exact-node chemistry
rule, the loaders' error messages, ``TopTemperatureSchedule``."""

import os

import numpy as np
import pytest
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "surface_bc_case21.dat")
BRANCHES = ["chemistry_blowing", "chemistry_no_blowing", "cooling_standard",
            "cooling_exact"]


def _pkgs():
    from cmfem_tpu.physics import bprime as JB, seb as JS, surface_bc as JBC
    from cmfem_tpu_torch.physics import bprime as PB, seb as PS, \
        surface_bc as PBC

    return (JS, JBC, JB), (PS, PBC, PB)


def _close(a, b, tol=1e-13):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


def test_classify_branch_all_four():
    for S, BC, _ in _pkgs():
        off, exact = S.SurfaceFluxModel(), \
            S.SurfaceFluxModel(pato_compat_mode="cooling_exact")
        cases = [(BC.BoundaryState(101325.0, 0.3, 1.5e6), off,
                  S.BRANCH_CHEMISTRY_BLOWING),
                 (BC.BoundaryState(101325.0, 0.0, 1.5e6), off,
                  S.BRANCH_CHEMISTRY_NO_BLOWING),
                 (BC.BoundaryState(101325.0, -1.0, 1.5e6), exact,
                  S.BRANCH_CHEMISTRY_NO_BLOWING),
                 (BC.BoundaryState(101325.0, 0.3, 0.0, chemistryOn=0), off,
                  S.BRANCH_COOLING_STANDARD),
                 (BC.BoundaryState(101325.0, 0.3, 0.0, chemistryOn=0), exact,
                  S.BRANCH_COOLING_EXACT)]
        assert [S.classify_branch(bc, m) for bc, m, _ in cases] == \
            [b for *_, b in cases]
    assert _pkgs()[1][0].BRANCH_COOLING_EXACT == "cooling_exact"


def test_blowing_correction_and_its_derivative():
    import jax
    import jax.numpy as jnp

    (JS, _, _), (PS, _, _) = _pkgs()
    # values across the series cutoff arg = 2 lam Bg = 1e-10
    Bg = np.array([-1.0, 0.0, 1e-12, 9.9e-11, 1e-10, 1.01e-10, 1e-6, 0.01,
                   0.1, 1.0, 10.0])
    # derivatives where log1p(arg)/arg is well conditioned: its derivative
    # cancels two ~1/arg terms, so each package's jvp rounding leaves
    # ~eps/arg (~1e-6 just above the cutoff, held to the analytic -lam
    # below)
    smooth = np.array([-1.0, 0.0, 1e-12, 9.9e-11, 0.05, 0.1, 1.0, 10.0])
    for lam in (0.5, 0.25):
        _close(JS.blowing_correction(jnp.asarray(Bg), lam),
               PS.blowing_correction(torch.tensor(Bg), lam))
        dphi = lambda x: torch.func.vmap(torch.func.jacfwd(
            lambda b: PS.blowing_correction(b, lam)))(torch.tensor(x))
        jd = jax.vmap(jax.jacfwd(lambda b: JS.blowing_correction(b, lam)))(
            jnp.asarray(smooth))
        _close(jd, dphi(smooth))
        near = dphi(Bg[4:7]).numpy()
        assert np.abs(near + lam).max() <= 1e-5
    # at Bg = 0, max(Bg, 0) splits its derivative: d phi/dBg = -lam / 2
    assert float(dphi(np.zeros(1))[0]) == pytest.approx(-0.125, rel=1e-12)
    assert float(jd[1]) == pytest.approx(-0.125, rel=1e-12)


@pytest.mark.parametrize("which", ["solve_blowing", "solve_blowing_22"])
def test_fixed_points_and_jacfwd_match_jax(which):
    import jax
    import jax.numpy as jnp

    (JS, _, JB), (PS, _, PB) = _pkgs()
    # 1e-12 keeps 2 lam B'g below the series cutoff (just above it the
    # derivative is roundoff: see test_blowing_correction_and_its_derivative)
    m = np.array([-0.01, 0.0, 1e-12, 3.6e-4, 1e-3, 0.01, 0.2])
    T = np.linspace(400.0, 3500.0, m.size)
    jt, pt = JB.BPrimeTable.synthetic_tacot(), PB.BPrimeTable.synthetic_tacot()
    configs = [(0.3, True, True, False), (0.3, True, True, True),
               (0.3, False, True, False)]
    if which == "solve_blowing":
        # the floored rhoeUeCH, and no table: cheap for the JAX side
        configs += [(0.0, True, True, False), (0.3, True, False, False)]
    for rh, enable, chem, strict in configs:
        if which == "solve_blowing":
            jf = lambda m: JS.solve_blowing(m, rh, 0.5, enable)
            pf = lambda m: PS.solve_blowing(m, rh, 0.5, enable)
        else:
            jf = lambda m: JS.solve_blowing_22(
                m, rh, 101325.0, jnp.asarray(T), jt, chem, strict, 0.5,
                enable)
            pf = lambda m: PS.solve_blowing_22(
                m, rh, 101325.0, torch.tensor(T), pt, chem, strict, 0.5,
                enable)
        # one JAX program for the values and their jacfwd
        jv, jd = jax.jit(lambda m: (jf(m), jax.jacfwd(
            lambda m: jnp.stack(jf(m)))(m)))(jnp.asarray(m))
        for a, b in zip(jv, pf(torch.tensor(m))):
            _close(a, b)
        pd = torch.func.jacfwd(lambda m: torch.stack(pf(m)))(torch.tensor(m))
        _close(jd, pd)
    if which == "solve_blowing_22":
        out = PS.solve_blowing_22(torch.tensor(m), 0.3, 101325.0,
                                  torch.tensor(T), pt, True, False, 0.5, True,
                                  return_lut=True)
        assert len(out) == 4 and set(out[3]) >= {"bc", "hw"}
        _close(out[1], out[3]["bc"], 0.0)


@pytest.mark.parametrize("case22", [False, True])
@pytest.mark.parametrize("branch", BRANCHES)
def test_surface_flux_matches_jax(branch, case22):
    import jax.numpy as jnp

    (JS, JBC, JB), (PS, PBC, PB) = _pkgs()
    rng = np.random.default_rng(11)
    shape = (5, 3)
    m = rng.uniform(-1e-3, 5e-3, shape)
    m[0, 0] = 0.0
    hg = rng.uniform(1e5, 3e6, shape)
    T = rng.uniform(300.0, 3000.0, shape)
    eps, absb, refl = (rng.uniform(0.5, 0.95, shape) for _ in range(3))
    kw = {"pato_compat_mode": "cooling_exact"} \
        if branch == "cooling_exact" else {}
    chem = int(branch.startswith("chemistry"))
    rh = 0.0 if branch == "chemistry_no_blowing" else 0.3
    bc_args = (101325.0, rh, 1.5e6, 10.0, 350.0, True, True, chem)
    outs = []
    for S, BC, B, xp in ((JS, JBC, JB, jnp.asarray),
                         (PS, PBC, PB, torch.tensor)):
        model = S.SurfaceFluxModel(q_rad=2.0e4, case22=case22,
                                   strict_case2_2=False, **kw)
        bc = BC.BoundaryState(*bc_args)
        assert S.classify_branch(bc, model) == branch
        table = B.BPrimeTable.synthetic_tacot()
        outs.append((S.surface_flux(xp(m), xp(hg), xp(T), xp(eps), xp(absb),
                                    xp(refl), bc, branch, model, table,
                                    count_clamps=True), table))
    (jo, jt), (po, pt) = outs
    assert set(jo) == set(po)
    for k in jo:
        a = np.broadcast_to(np.asarray(jo[k], dtype=np.float64),
                            po[k].shape)
        _close(a, po[k])
    assert vars(pt.clamp_stats) == vars(jt.clamp_stats)
    if branch == "chemistry_blowing":
        assert float(po["BprimeG"].max()) > 0
    if case22 and branch == "chemistry_blowing":
        assert float(po["m_dot_c"].max()) > 0


# -- the schedules -----------------------------------------------------------

def test_fixture_schedule_matches_jax_and_switches_at_the_node():
    """The case-2.1 fixture (7 columns): rhoeUeCH ramps 0 -> 0.3 over the
    first 0.1 s with h_r 1.5e6; chemistry stays on through the node at
    0.4 s and is off from 0.41 s (hconv 10, Tedge 300)."""
    (JS, JBC, _), (PS, PBC, _) = _pkgs()
    js, ps = JBC.SurfaceBCSchedule.load_file(FIXTURE), \
        PBC.SurfaceBCSchedule.load_file(FIXTURE)
    assert ps.has_hconv and js.has_hconv
    np.testing.assert_array_equal(ps.rows, js.rows)
    model = PS.SurfaceFluxModel()
    for t in (0.0, 0.05, 0.1, 0.3, 0.4, 0.405, 0.41, 0.5, 1.7, 2.0, 3.0):
        a, b = js.eval(t), ps.eval(t)
        assert vars(a) == vars(b), t
    assert ps.eval(0.05).rhoeUeCH == pytest.approx(0.15, abs=1e-12)
    assert ps.eval(0.1).h_r == pytest.approx(1.5e6)
    branch = lambda t: PS.classify_branch(ps.eval(t), model)
    assert branch(0.0) == "chemistry_no_blowing"
    assert [branch(0.1 * k) for k in range(1, 7)] == \
        ["chemistry_blowing"] * 4 + ["cooling_standard"] * 2
    assert ps.eval(0.4).chemistryOn == 1 and ps.eval(0.41).chemistryOn == 1
    assert ps.eval(0.4100001).chemistryOn == 0
    assert (ps.eval(0.5).hconv, ps.eval(0.5).Tedge) == pytest.approx(
        (10.0, 300.0), rel=1e-15)


def test_five_column_schedule_and_exact_node_rule(tmp_path):
    """At a time exactly on an interior node the left-constant chemistry
    toggle takes the PRE-node row (side='left')."""
    path = tmp_path / "five.dat"
    path.write_text("// t p_w rhoeUeCH h_r chem\n"
                    "60.0  101325 0.3 1.5e6 1\n"
                    "0.0   101325 0.0 1.0e6 0   // unsorted rows sort\n"
                    "\n"
                    "120.0 101325 0.3 1.5e6 1\n")
    (_, JBC, _), (_, PBC, _) = _pkgs()
    for BC in (JBC, PBC):
        s = BC.SurfaceBCSchedule.load_file(str(path))
        assert not s.has_hconv
        assert s.eval(59.9).chemistryOn == 0
        assert s.eval(60.0).chemistryOn == 0   # the pre-node row governs
        assert s.eval(60.1).chemistryOn == 1
        assert s.eval(60.0).rhoeUeCH == pytest.approx(0.3, abs=1e-12)
        b = s.eval(30.0)
        assert (b.hconv, b.Tedge, b.has_hconv) == (0.0, 300.0, False)
        assert s.eval(-1.0).chemistryOn == 0 and s.eval(500.0).h_r == 1.5e6
    js, ps = JBC.SurfaceBCSchedule.load_file(str(path)), \
        PBC.SurfaceBCSchedule.load_file(str(path))
    for t in np.linspace(-5.0, 130.0, 28):
        assert vars(js.eval(float(t))) == vars(ps.eval(float(t)))


@pytest.mark.parametrize("body,match", [
    ("0.0 1 2 3 x\n", "Invalid numeric value .* line 1"),
    ("0.0 1 2 3\n", "line 1 must have 5 or 7"),
    ("0.0 1 2 3 1\n0.1 1 2 3 4 5 1\n", "Inconsistent .* line 2"),
    ("// only a comment\n", "no valid rows"),
])
def test_schedule_errors_match_jax(tmp_path, body, match):
    path = tmp_path / "bad.dat"
    path.write_text(body)
    msgs = []
    for _, BC, _ in _pkgs():
        with pytest.raises(ValueError, match=match) as e:
            BC.SurfaceBCSchedule.load_file(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_top_temperature_schedule(tmp_path):
    (_, JBC, _), (_, PBC, _) = _pkgs()
    good = tmp_path / "top.dat"
    good.write_text("// t T\n0 300\n0.1 1644 extra\n\n60 1644\n60.1 300\n")
    for BC in (JBC, PBC):
        s = BC.TopTemperatureSchedule.load_file(str(good))
        assert [s.eval(t) for t in (-1.0, 0.05, 30.0, 60.05, 99.0)] == \
            pytest.approx([300.0, 972.0, 1644.0, 972.0, 300.0])
    for body, match in (("0 300\nx 1\n", "Unparseable .* line 2"),
                        ("-1 300\n", "Negative time .* line 1"),
                        ("1 300\n0.5 400\n", "nondecreasing at line 2"),
                        ("// none\n", "is empty")):
        (tmp_path / "bad.dat").write_text(body)
        msgs = []
        for BC in (JBC, PBC):
            with pytest.raises(ValueError, match=match) as e:
                BC.TopTemperatureSchedule.load_file(str(tmp_path / "bad.dat"))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="empty"):
        PBC.TopTemperatureSchedule([], [])
