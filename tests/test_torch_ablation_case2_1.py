"""Port parity, the ``ablation_case2_1`` driver: both packages' ``run`` on a
3 x 40 strip (GMSH file written by the test) with the synthetic TACOT deck
and B' table and the schedule fixture ``surface_bc_case21.dat``, 6 steps of
dt 0.1 across the chemistry switch (steps 1-4 on the chemistry-blowing
branch, step 4 on the 0.4 s node, steps 5-6 cooling), float64 on the CPU.
The JAX eager driver runs once; the port's host-LU, ``gmres`` and
``scan_stepping`` paths each match its probe, mass, boundary, Newton and
B' clamp-statistics CSVs to rtol 1e-7 (the Newton residual and update
columns beside their floor, as in the case-1 parity test), with equal
Newton counts, and agree with each other to 1e-8.  The variants:
``temperature_dirichlet`` (eager = scan to 1e-8) and ``cooling_exact``
(eager = scan, resumed from the port's own checkpoint).  Restart: the port
resumes from the JAX checkpoint and ends where the JAX straight run ends
(T atol 2e-5, p rtol 1e-7), the JAX ``load_restart`` reads the port's
checkpoint with equal arrays, and the guards raise with the JAX messages;
``jacobian_check`` skips the blowing branch (B'g = 0 clamps at p uniform)
and passes the cooling one; ``main`` runs from a YAML file; no device means
CUDA; the distributed options and float32 raise."""

import os

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, TOP, strip_file, one_torch_thread)

SCHED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "surface_bc_case21.dat")
CSVS = ("temperature_probes.csv", "mass_metrics.csv",
        "boundary_diagnostics.csv", "newton_history_ablation_case2_1_2D.csv")
# GMRES at linear_rtol 1e-12: held to the JAX host LU, whose directions
# the default 1e-10 leaves ~1e-4 of in the late, small Newton updates of
# these ill-conditioned systems
MODES = {"lu": {}, "gmres": {"linear_solver": "gmres", "linear_rtol": 1e-12},
         "scan": {"scan_stepping": True}}


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    return strip_file(tmp_path_factory.mktemp("mesh"), 3, 40)


def _cfg(strip, out, **extra):
    return {"mesh_file": strip, "material_file": FIXTURE,
            "boundary_conditions_file": SCHED, "order": 1, "dt": 0.1,
            "t_final": 0.6, "bdr_attr_top": TOP, "probe_x": 0.00125,
            "newton_print_level": 0, "save_paraview": False,
            "output_every": 2, "output_path": str(out), **extra}


def _read(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def _newton_counts(path):
    """Linear solves per step, from a Newton CSV (rows per step - 1)."""
    _, rows = _read(path)
    steps = rows[:, 0].astype(int)
    return [int((steps == s).sum()) - 1 for s in np.unique(steps)]


def _close(a, b, what, rtol=1e-7, floor=1e-12, newton_rtol=1e-7):
    """rtol, with a floor of 1e-12 x the column's largest value (values
    that are zero in one run and roundoff in the other); the residual and
    update columns of a Newton CSV to ``newton_rtol`` or within ``floor``
    x the column's largest value."""
    assert a.shape == b.shape, what
    scale = np.abs(b).max(axis=0)
    atol = np.where(scale > 0, 1e-12 * scale, 1e-300)
    rt = np.full(b.shape[1], rtol)
    if what.startswith("newton"):
        cols = [3, 5, 6, 8]
        atol[cols] = floor * scale[cols]
        rt[cols] = newton_rtol
    bad = np.abs(a - b) > rt * np.abs(b) + atol
    assert not bad.any(), (what, np.argwhere(bad)[:5])


@pytest.fixture(scope="module")
def runs(strip, tmp_path_factory):
    """The JAX eager run (writing a checkpoint at t = 0.3) and the port's
    three paths (the host-LU run writing one at t = 0.4)."""
    from cmfem_tpu.apps import ablation_case2_1 as J
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    d = tmp_path_factory.mktemp("runs")
    out = {"dir": d, "jax": J.run(_cfg(
        strip, d / "jax", restart_write_file=str(d / "jax.chk"),
        restart_write_at_time=0.3, restart_write_at_end=False))}
    for mode, extra in MODES.items():
        if mode == "lu":
            extra = {**extra, "restart_write_file": str(d / "port.chk"),
                     "restart_write_at_time": 0.4,
                     "restart_write_at_end": False}
        out[mode] = P.run(_cfg(strip, d / mode, **extra), device="cpu")
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_case21_csvs_match_jax(runs, mode):
    d = runs["dir"]
    # the converged residuals and the last updates sit at GMRES's floor
    floor, newton_rtol = (1e-9, 1e-6) if mode == "gmres" else (1e-12, 1e-7)
    for name in ("amaryllis_error_tolerances.csv", "bprime_clamp_stats.csv"):
        with open(d / mode / name) as fp, open(d / "jax" / name) as fj:
            assert fp.read() == fj.read(), name
    for name in CSVS:
        hp, a = _read(d / mode / name)
        hj, b = _read(d / "jax" / name)
        assert hp == hj, name
        _close(a, b, name, floor=floor, newton_rtol=newton_rtol)
    port = runs[mode]
    assert port["newton_iters"] == _newton_counts(d / "jax" / CSVS[3]) \
        and len(port["newton_iters"]) == 6
    assert port["converged"] and (port["step"], port["time"]) == \
        (runs["jax"]["step"], runs["jax"]["time"])
    np.testing.assert_allclose(port["T"], runs["jax"]["T"], rtol=1e-9)
    np.testing.assert_allclose(port["p"], runs["jax"]["p"], rtol=1e-9)
    assert len(port["timing"]) == 6 and all(
        set(t) >= {"residual", "jacobian", "factorization", "linear",
                   "update", "state", "output", "total"}
        for t in port["timing"])
    # the wall heated on the blowing branch and cooled after the switch;
    # B'g stayed inside the table's range while blowing
    _, bdr = _read(d / mode / CSVS[2])
    assert (bdr[1:5, 9] > 0).all() and (bdr[5:, 9] < 0).all()
    assert (bdr[1:5, 2] > 1e-4).all() and (bdr[5:, 2] == 0).all()
    _, mass = _read(d / mode / CSVS[1])
    assert (mass[1:, 1] > 0).all()


def test_the_three_paths_agree(runs):
    d = runs["dir"]
    for mode in ("gmres", "scan"):
        for name in CSVS[:3]:
            _, a = _read(d / mode / name)
            _, b = _read(d / "lu" / name)
            scale = np.abs(b).max(axis=0)
            assert (np.abs(a - b) <= 1e-8 * np.abs(b) + 1e-12 * scale).all()
    assert runs["scan"]["linear_solver"] == "BlockTridiagDirect"
    assert all(k and all(i <= 2 for i in k)
               for k in runs["scan"]["krylov_iters"])


def test_temperature_dirichlet_eager_equals_scan(strip, tmp_path):
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    top = tmp_path / "top.dat"
    top.write_text("// t T\n0 300\n0.1 1200\n1 1200\n")
    base = dict(top_thermal_bc="temperature_dirichlet",
                top_temperature_file=str(top), t_final=0.3)
    r = {scan: P.run(_cfg(strip, tmp_path / str(scan), scan_stepping=scan,
                          **base), device="cpu")
         for scan in (False, True)}
    for k in ("T", "p"):
        a, b = r[True][k], r[False][k]
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()
    assert r[False]["newton_iters"] == r[True]["newton_iters"]
    for name in CSVS[:3]:
        _, a = _read(tmp_path / "True" / name)
        _, b = _read(tmp_path / "False" / name)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        scale = np.abs(b).max(axis=0)
        assert (np.abs(a - b) <= 1e-8 * np.abs(b) + 1e-12 * scale).all()
    _, probes = _read(tmp_path / "False" / CSVS[0])
    assert probes[1:, 1] == pytest.approx([1200.0] * 3)      # the wall
    _, bdr = _read(tmp_path / "False" / CSVS[2])
    assert np.isfinite(bdr[:, 1]).all() and np.isnan(bdr[:, 2:]).all()


def test_cooling_exact_eager_equals_scan(runs, strip, tmp_path):
    """From the port's t = 0.4 checkpoint, the two cooling steps under
    ``pato_compat_mode: cooling_exact`` (the pyrolysis gas leaves at its
    own enthalpy, where the standard cooling branch drops the advection
    term with h_w = 0)."""
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    base = dict(pato_compat_mode="cooling_exact",
                restart_read_file=str(runs["dir"] / "port.chk"))
    r = {scan: P.run(_cfg(strip, tmp_path / str(scan), scan_stepping=scan,
                          **base), device="cpu")
         for scan in (False, True)}
    for k in ("T", "p"):
        a, b = r[True][k], r[False][k]
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()
    assert (r[False]["step"], r[True]["step"]) == (6, 6)
    assert len(r[False]["timing"]) == 2 == len(r[True]["timing"])
    _, exact = _read(tmp_path / "False" / CSVS[2])
    _, std = _read(runs["dir"] / "lu" / CSVS[2])
    assert exact.shape == (3, 14)
    np.testing.assert_allclose(exact[0], std[4], rtol=1e-12)   # t = 0.4
    assert (exact[1:, 10] != 0).all() and (std[5:, 10] == 0).all()
    assert np.abs(r[False]["T"] - runs["lu"]["T"]).max() > 1e-6


def test_restart_crosses_the_packages(runs, strip, tmp_path):
    from cmfem_tpu.apps import ablation_case2_1 as J
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    d = runs["dir"]
    # the port resumes from the JAX checkpoint (t = 0.3) to the end
    r = P.run(_cfg(strip, tmp_path, restart_read_file=str(d / "jax.chk")),
              device="cpu")
    assert (r["step"], r["time"]) == (6, pytest.approx(0.6, abs=1e-12))
    np.testing.assert_allclose(r["T"], runs["jax"]["T"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(r["p"], runs["jax"]["p"], rtol=1e-7)
    np.testing.assert_allclose(r["T"], runs["lu"]["T"], rtol=0, atol=2e-5)
    # the JAX package reads the port's checkpoint (t = 0.4), and the port
    # the JAX one, with equal arrays
    shape = (len(runs["lu"]["T"]),) + tuple(runs["lu"]["state"].extent.shape)
    for chk, t, step in ((d / "port.chk.npz", 0.4, 4),
                         (d / "jax.chk.npz", 0.3, 3)):
        a = J.load_restart(str(chk), *shape)
        b = P.load_restart(str(chk), *shape)
        assert (a[0], b[0]) == (step, step)
        assert a[1] == b[1] == pytest.approx(t, abs=1e-12)
        for x, y in zip(a[2:], b[2:]):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)
    with np.load(d / "port.chk.npz") as p_, np.load(d / "jax.chk.npz") as j_:
        assert set(p_.files) == set(j_.files)
        assert all(p_[k].dtype == j_[k].dtype for k in p_.files)


def test_restart_guards_raise_as_jax(tmp_path):
    from cmfem_tpu.apps import ablation_case2_1 as J
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    T, p, X = np.arange(6.0), np.arange(6.0) + 10.0, np.zeros((2, 4, 3))
    good = str(tmp_path / "good.npz")
    P.save_restart(good, 3, 0.3, torch.tensor(T), p, X,
                   elem_order="strip-row-major")
    bad = tmp_path / "bad.npz"
    with np.load(good) as dd:
        np.savez(bad, **{**dict(dd), "magic": np.uint64(7)})
    cases = [(str(bad), (6, 2, 4, 3), {}, "magic"),
             (good, (6, 2, 4, 3), {"world_size": 2}, "world size"),
             (good, (7, 2, 4, 3), {}, "size mismatch"),
             (good, (6, 2, 4, 2), {}, "shape mismatch"),
             (good, (6, 2, 4, 3), {}, "element-order mismatch")]
    for path, shape, kw, match in cases:
        kw = {"elem_order": "strip-row-major", **kw} \
            if match != "element-order mismatch" else kw
        msgs = []
        for M in (J, P):
            with pytest.raises(ValueError, match=match) as e:
                M.load_restart(path, *shape, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # the path without its .npz suffix, as the drivers write it
    out = P.load_restart(good[:-4], 6, 2, 4, 3, elem_order="strip-row-major")
    assert out[:2] == (3, 0.3) and np.array_equal(out[2], T)


def test_jacobian_check_per_branch_in_the_driver(strip, tmp_path, capsys):
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    r = P.run(_cfg(strip, tmp_path, t_final=0.5, jacobian_check=True),
              device="cpu")
    jc = r["jacobian_check"]
    assert set(jc) == {"domain", "chemistry_blowing", "cooling_standard"}
    assert jc["chemistry_blowing"] is None
    assert 0.0 <= jc["domain"] < 1e-4 and 0.0 <= jc["cooling_standard"] < 1e-4
    out = capsys.readouterr().out
    assert "jacobian_check (domain blocks) passed" in out
    assert "branch=chemistry_blowing) skipped: non-smooth" in out
    assert "branch=cooling_standard) passed" in out


def test_main_runs_from_a_yaml_file(strip, tmp_path, monkeypatch, capsys):
    pytest.importorskip("yaml")
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    cfg = _cfg(strip, tmp_path / "out", t_final=0.1)
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str)
                            else f"{k}: {v}\n" for k, v in cfg.items()))
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    assert P.main(["-i", str(path)]) == 0
    assert "step=1 t=0.1 [chemistry_blowing]" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / CSVS[2])


def test_run_refuses_what_it_does_not_do(strip, tmp_path, monkeypatch):
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    cfg = _cfg(strip, tmp_path)
    for extra, err, match in (
            ({"sharding_devices": 2, "dof_partition": 2}, ValueError,
             "sharding_devices and dof_partition are mutually exclusive"),
            ({"scan_stepping": True, "sharding_devices": 2},
             NotImplementedError, "scan_stepping is mutually exclusive "
             "with sharding_devices / dof_partition"),
            ({"scan_stepping": True, "dof_partition": 2},
             NotImplementedError, "scan_stepping is mutually exclusive "
             "with sharding_devices / dof_partition"),
            ({"scan_stepping": True, "order": 2}, NotImplementedError,
             "order 1"),
            ({"scan_stepping": True, "jacobian_check": True},
             NotImplementedError, "eager path"),
            ({"pato_compat_mode": "on"}, ValueError, "pato_compat_mode")):
        with pytest.raises(err, match=match):
            P.run({**cfg, **extra}, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        P.run(cfg, device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run(cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lu", "scan"])
def test_cuda_case21_step_equals_cpu(strip, tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.apps import ablation_case2_1 as P

    out = {dev: P.run(_cfg(strip, tmp_path / dev, t_final=0.1,
                           **MODES[mode]), device=dev)
           for dev in ("cpu", "cuda")}
    assert out["cuda"]["newton_iters"] == out["cpu"]["newton_iters"]
    np.testing.assert_allclose(out["cuda"]["T"], out["cpu"]["T"], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"]["p"], out["cpu"]["p"], rtol=1e-9)
