"""Port parity, ``physics/bprime.py``: the B' table's loaders and its
(p, B'g, T) lookup against the JAX package's, float64 on the CPU.  The
synthetic TACOT table's ten outputs agree to 1e-13 on seeded random queries
with points outside each axis, B'g exactly on a level and B'g = 0; so do a
ragged table's (per-level T rows of different counts and ranges) and a
table read from a PATO-format file; ``vmap(jacfwd)`` through ``lookup``
equals ``jax.vmap(jax.jacfwd)``; ``count_clamps`` adds what JAX adds."""

import numpy as np
import pytest
import torch

KEYS = ("bc", "hw", "dbc_dbg", "dbc_dT", "dhw_dbg", "dhw_dT", "clamped_p",
        "clamped_bg", "clamped_t", "nonsmooth_bg")


def _queries(seed=0, n=64):
    rng = np.random.default_rng(seed)
    p = 10.0 ** rng.uniform(2.8, 5.2, n)
    bg = 10.0 ** rng.uniform(-4.5, 1.3, n)
    T = rng.uniform(150.0, 4100.0, n)
    p[:3] = (500.0, 2.0e5, 101325.0)         # below, above, on the top level
    bg[3:7] = (0.0, 1e-2, 1e-5, 50.0)        # zero, on a level, below, above
    T[7:10] = (100.0, 5000.0, 200.0)         # below, above, on the first knot
    return p, bg, T


def _tables(make):
    from cmfem_tpu.physics.bprime import BPrimeTable as J
    from cmfem_tpu_torch.physics.bprime import BPrimeTable as P

    return make(J), make(P)


def _assert_lookup_equal(jt, pt, p, bg, T, tol=1e-13):
    import jax.numpy as jnp

    jo = jt.lookup(jnp.asarray(p), jnp.asarray(bg), jnp.asarray(T))
    po = pt.lookup(torch.tensor(p), torch.tensor(bg), torch.tensor(T))
    assert set(po) == set(KEYS) == set(jo)
    for k in KEYS:
        a, b = np.asarray(jo[k]), po[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == bool:
            assert (a == b).all(), k
        else:
            assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300), k
    return jo, po


def test_synthetic_lookup_matches_jax():
    jt, pt = _tables(lambda B: B.synthetic_tacot())
    assert pt.uniform and pt.T_tab.shape == jt.T_tab.shape == (3, 6, 96)
    for name in ("p_levels", "bg_levels", "T_tab", "T_hi", "bc", "hw", "bc2",
                 "hw2"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
    _, po = _assert_lookup_equal(jt, pt, *_queries())
    # every flag is exercised by the queries
    for k in ("clamped_p", "clamped_bg", "clamped_t", "nonsmooth_bg"):
        assert po[k].any() and not po[k].all(), k
    assert po["nonsmooth_bg"][4] and not po["clamped_bg"][4]   # on a level


def _ragged(B):
    """The JAX package's ragged-table test deck: 5, 8 or 11 T rows per
    level over shifted ranges."""
    rng = np.random.default_rng(7)
    rows = []
    for i, pv in enumerate([1013.25, 101325.0]):
        for j, bgv in enumerate([0.01, 0.1, 1.0]):
            nT = 5 + 3 * ((i + j) % 3)
            Tlo = 300.0 + 50.0 * i + 20.0 * j
            Tg = np.sort(Tlo + np.cumsum(150.0 + 50.0 * rng.random(nT)))
            bcv = 0.1 + 0.05 * j + 1e-4 * (Tg - Tg[0]) \
                + 2e-8 * (Tg - Tg[0]) ** 2
            hwv = 1e3 * (Tg - 298.0) - 1e5 * bgv
            rows += [(pv, bgv, bcv[k], Tg[k], hwv[k]) for k in range(nT)]
    a = np.asarray(rows)
    return B.from_rows(a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4])


def test_ragged_table_matches_jax():
    jt, pt = _tables(_ragged)
    assert not pt.uniform and not jt.uniform
    np.testing.assert_array_equal(pt.T_tab, jt.T_tab)
    np.testing.assert_array_equal(pt.bc2, jt.bc2)
    p, bg, T = _queries(seed=1)
    T = np.concatenate([T, [450.0, 900.0, 1700.0, 2600.0, 9000.0]])
    p = np.concatenate([p, np.full(5, 5000.0)])
    bg = np.concatenate([bg, np.full(5, 0.3)])
    _, po = _assert_lookup_equal(jt, pt, p, bg, T)
    assert po["clamped_t"][-1] and po["dbc_dT"][-1] == 0.0


def test_load_file_matches_jax(tmp_path):
    path = tmp_path / "bprime.dat"
    lines = ["// synthetic B' table: p  B'g  B'c  T  h_w", "garbage line"]
    for pv in (1.0e3, 1.0e5):
        for bgv in (1e-3, 1e-1, 1.0):
            for T in (300.0, 900.0, 1500.0, 2400.0):
                bc = 0.1 / (1 + bgv) + 1e-5 * T * float(np.log10(pv))
                lines.append(f"{pv} {bgv} {bc!r} {T} {1.1e3 * (T - 298.0)}"
                             "  // trailing comment")
    path.write_text("\n".join(lines) + "\n")
    jt, pt = _tables(lambda B: B.load_file(str(path)))
    assert pt.T_tab.shape == (2, 3, 4) and pt.uniform
    _assert_lookup_equal(jt, pt, *_queries(seed=2))
    (tmp_path / "empty.dat").write_text("// nothing\n")
    for B in _tables(lambda B: B):
        with pytest.raises(ValueError, match="no readable data"):
            B.load_file(str(tmp_path / "empty.dat"))
    rows = np.array([[1e3, 0.1, 0.2, 300.0, 1.0], [1e3, 0.1, 0.3, 400.0, 2.0],
                     [1e5, 1.0, 0.2, 300.0, 1.0], [1e5, 1.0, 0.2, 500.0, 1.0]])
    for B in _tables(lambda B: B):
        with pytest.raises(ValueError, match="every .p, B'g. combination"):
            B.from_rows(*rows.T)


def test_count_clamps_adds_what_jax_adds():
    import jax.numpy as jnp

    jt, pt = _tables(lambda B: B.synthetic_tacot())
    p, bg, T = _queries()
    jt.lookup(jnp.asarray(p), jnp.asarray(bg), jnp.asarray(T),
              count_clamps=True)
    pt.lookup(torch.tensor(p), torch.tensor(bg), torch.tensor(T),
              count_clamps=True)
    assert vars(pt.clamp_stats) == vars(jt.clamp_stats)
    assert min(vars(pt.clamp_stats).values()) > 0


@pytest.mark.parametrize("table", ["synthetic", "ragged"])
def test_vmap_jacfwd_through_lookup_matches_jax(table):
    """d(B'c, h_w)/d(B'g, T) per query by ``vmap(jacfwd)``, as the face
    Jacobians take it, against ``jax.vmap(jax.jacfwd)``."""
    import jax
    import jax.numpy as jnp

    make = (lambda B: B.synthetic_tacot()) if table == "synthetic" \
        else _ragged
    jt, pt = _tables(make)
    p, bg, T = _queries(seed=3, n=24)
    # on the lowest B'g level and on the first level's first T knot: the
    # clips' ties, where both packages split the derivative 0.5 / 0.5
    bg[3], T[4] = pt.bg_levels[0], pt.T_tab[0, 0, 0]

    def jf(bg, T, p):
        o = jt.lookup(p, bg, T)
        return jnp.stack([o["bc"], o["hw"]])

    def pf(bg, T, p):
        o = pt.lookup(p, bg, T)
        return torch.stack([o["bc"], o["hw"]])

    jd = jax.vmap(jax.jacfwd(jf, argnums=(0, 1)))(
        jnp.asarray(bg), jnp.asarray(T), jnp.asarray(p))
    pd = torch.func.vmap(torch.func.jacfwd(pf, argnums=(0, 1)))(
        torch.tensor(bg), torch.tensor(T), torch.tensor(p))
    for a, b in zip(jd, pd):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-13 * np.abs(a).max()
    # the T derivative is the table's own dT output where nothing clamps
    o = pt.lookup(torch.tensor(p), torch.tensor(bg), torch.tensor(T))
    free = ~(o["clamped_t"] | o["clamped_p"]).numpy()
    np.testing.assert_allclose(pd[1].numpy()[free, 0], o["dbc_dT"][free],
                               rtol=1e-12, atol=1e-16)
