"""Port parity, the ``ablation_case1`` driver: both packages' ``run`` on a
3 x 40 strip (GMSH file written by the test) with the synthetic TACOT deck,
3 steps of dt 0.1 under the default wall schedule, float64 on the CPU,
through the host LU (the default), ``linear_solver: gmres`` and
``scan_stepping: true``.  The probe, mass and Newton CSVs have the JAX
driver's headers and agree with its values to rtol 1e-7 (the Newton
residual and update columns beside their floor: 1e-12 of the column's
largest value for the direct solves; for GMRES, stopped at rtol 1e-10 of an
ill-conditioned system, 1e-9 and rtol 1e-6), with equal Newton counts per
step; the three port paths agree with each other to 1e-8; the
lattice residual path gives the generic one's run; ``main`` runs from a
YAML file; no device means CUDA; the distributed options and float32
raise."""

import os

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, TOP, strip_file, one_torch_thread)

CSVS = ("temperature_probes.csv", "mass_metrics.csv",
        "newton_history_ablation_case1_2D.csv")
MODES = {"lu": {}, "gmres": {"linear_solver": "gmres"},
         "scan": {"scan_stepping": True}}


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    return strip_file(tmp_path_factory.mktemp("mesh"), 3, 40)


def _cfg(strip, out, **extra):
    return {"mesh_file": strip, "material_file": FIXTURE, "order": 1,
            "dt": 0.1, "t_final": 0.3, "bdr_attr_top": TOP,
            "probe_x": 0.00125, "newton_print_level": 0,
            "save_paraview": False, "output_every": 2, "output_path": out,
            **extra}


def _read(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def _newton_counts(path):
    """Linear solves per step, from a Newton CSV (rows per step - 1)."""
    _, rows = _read(path)
    steps = rows[:, 0].astype(int)
    return [int((steps == s).sum()) - 1 for s in np.unique(steps)]


def _close(a, b, floor, what, newton_rtol=1e-7):
    """rtol 1e-7; the residual/update columns of the Newton CSV to
    ``newton_rtol`` or within ``floor`` x the column's largest value."""
    scale = np.abs(b).max(axis=0)
    atol = np.where(scale > 0, 1e-12 * scale, 1e-300)
    rtol = np.full(b.shape[1], 1e-7)
    if what.startswith("newton"):
        cols = [3, 5, 6, 8]
        atol[cols] = floor * scale[cols]
        rtol[cols] = newton_rtol
    bad = np.abs(a - b) > rtol * np.abs(b) + atol
    assert not bad.any(), (what, np.argwhere(bad)[:5])


@pytest.fixture(scope="module")
def runs(strip, tmp_path_factory):
    from cmfem_tpu.apps import ablation_case1 as J
    from cmfem_tpu_torch.apps import ablation_case1 as P

    d = tmp_path_factory.mktemp("runs")
    out = {}
    for mode, extra in MODES.items():
        out[mode] = {
            "port": P.run(_cfg(strip, str(d / f"port_{mode}"), **extra),
                          device="cpu"),
            "jax": J.run(_cfg(strip, str(d / f"jax_{mode}"), **extra)),
            "dirs": (str(d / f"port_{mode}"), str(d / f"jax_{mode}"))}
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_case1_csvs_match_jax(runs, mode):
    r = runs[mode]
    pdir, jdir = r["dirs"]
    # GMRES stops at a 1e-10 preconditioned residual of an ill-conditioned
    # system: its Newton updates agree to ~3e-7, its last residuals sit at
    # 1e-10 of the first
    floor, newton_rtol = (1e-9, 1e-6) if mode == "gmres" else (1e-12, 1e-7)
    with open(os.path.join(pdir, "fiat_error_tolerances.csv")) as fp, \
            open(os.path.join(jdir, "fiat_error_tolerances.csv")) as fj:
        assert fp.read() == fj.read()
    for name in CSVS:
        hp, a = _read(os.path.join(pdir, name))
        hj, b = _read(os.path.join(jdir, name))
        assert hp == hj and a.shape == b.shape, name
        _close(a, b, floor, name, newton_rtol)
    newton = _newton_counts(os.path.join(jdir, CSVS[2]))
    assert r["port"]["newton_iters"] == newton and len(newton) == 3
    assert r["port"]["converged"] and np.isfinite(r["port"]["T"]).all()
    np.testing.assert_allclose(r["port"]["T"], np.asarray(r["jax"]["T"]),
                               rtol=1e-9)
    np.testing.assert_allclose(r["port"]["p"], np.asarray(r["jax"]["p"]),
                               rtol=1e-9)
    timing = r["port"]["timing"]
    assert len(timing) == 3 and all(
        set(t) >= {"residual", "jacobian", "factorization", "linear",
                   "update", "state", "output", "total"} for t in timing)
    # the wall heated the strip and the pyrolysis gas came out of the top
    _, mass = _read(os.path.join(pdir, CSVS[1]))
    assert (mass[1:, 1] > 0).all() and (mass[1:, 3] > 0).all()


def test_the_three_paths_agree(runs):
    ref = runs["lu"]["dirs"][0]
    for mode in ("gmres", "scan"):
        for name in CSVS[:2]:
            _, a = _read(os.path.join(runs[mode]["dirs"][0], name))
            _, b = _read(os.path.join(ref, name))
            scale = np.abs(b).max(axis=0)
            assert (np.abs(a - b) <= 1e-8 * np.abs(b) + 1e-12 * scale).all()
    assert runs["scan"]["port"]["linear_solver"] == "BlockTridiagDirect"
    assert all(k and all(i <= 2 for i in k)
               for k in runs["scan"]["port"]["krylov_iters"])
    assert all(all(i > 10 for i in k)
               for k in runs["gmres"]["port"]["krylov_iters"])


def test_lattice_residual_run_equals_generic(runs, strip, tmp_path):
    from cmfem_tpu_torch.apps import ablation_case1 as P

    r = P.run(_cfg(strip, str(tmp_path), lattice_residual=True),
              device="cpu")
    np.testing.assert_allclose(r["T"], runs["lu"]["port"]["T"], rtol=1e-12)
    np.testing.assert_allclose(r["p"], runs["lu"]["port"]["p"], rtol=1e-12)
    assert r["newton_iters"] == runs["lu"]["port"]["newton_iters"]


def test_main_runs_from_a_yaml_file(strip, tmp_path, monkeypatch, capsys):
    pytest.importorskip("yaml")
    from cmfem_tpu_torch.apps import ablation_case1 as P

    cfg = _cfg(strip, str(tmp_path / "out"), t_final=0.1)
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str)
                            else f"{k}: {v}\n" for k, v in cfg.items()))
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    assert P.main(["-i", str(path)]) == 0
    assert "step=1" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / CSVS[0])


def test_run_refuses_what_it_does_not_do(strip, tmp_path, monkeypatch):
    from cmfem_tpu_torch.apps import ablation_case1 as P

    cfg = _cfg(strip, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run(cfg)
    with pytest.raises(ValueError, match="sharding_devices and "
                       "dof_partition are mutually exclusive"):
        P.run({**cfg, "sharding_devices": 2, "dof_partition": 2},
              device="cpu")
    for extra in ({"sharding_devices": 2}, {"dof_partition": 2}):
        with pytest.raises(ValueError, match="scan_stepping is mutually "
                           "exclusive with sharding_devices / dof_partition"):
            P.run({**cfg, **extra, "scan_stepping": True}, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        P.run(cfg, device="cpu", dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lu", "scan"])
def test_cuda_case1_step_equals_cpu(strip, tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.apps import ablation_case1 as P

    out = {dev: P.run(_cfg(strip, str(tmp_path / dev), t_final=0.1,
                           **MODES[mode]), device=dev)
           for dev in ("cpu", "cuda")}
    assert out["cuda"]["newton_iters"] == out["cpu"]["newton_iters"]
    np.testing.assert_allclose(out["cuda"]["T"], out["cpu"]["T"], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"]["p"], out["cpu"]["p"], rtol=1e-9)
