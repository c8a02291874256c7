"""Port parity, the ``ablation_case2_2`` driver: both packages' ``run`` on a
3 x 20 graded triangle strip (GMSH file written by the test) with the
synthetic TACOT deck and B' table, the schedule fixture
``surface_bc_case21.dat`` and the synthetic Amaryllis mass history
``amaryllis_mass_synthetic.dat``, 6 steps of dt 0.1 across the chemistry
switch at 0.41 s (steps 1-4 recede on the chemistry-blowing branch, steps
5-6 cool and stand still), float64 on the CPU.

The JAX eager driver runs once (writing an ALE checkpoint at t = 0.3); the
port's host-LU, ``gmres`` (linear_rtol 1e-12) and ``scan_stepping`` paths
each match its eight CSVs to rtol 1e-7 (the Newton residual and update
columns beside their floor, as in the case-2.1 parity test) with equal
Newton counts, its recession-metrics CSV to 1e-12, its vertices to 1e-12
(of the largest coordinate) and its total recession to 1e-8 relative; the
surface recedes from step 1 and every path moves on the same steps.
Restart: the port resumes from the JAX checkpoint and ends where the JAX
straight run ends, each package reads the other's checkpoint with equal
arrays, the guards raise in the JAX words.  ``jacobian_check`` in the
driver (with the mesh velocity in the domain blocks), ``main`` from a YAML
file (the production driver and the study variant), and the refusals: the
scan path's order 2, restart and ``jacobian_check``, the distributed
options, float32 and no CUDA device.  The quad strip's eager parity and
the study variant against JAX are in ``test_torch_ablation_case2_2_quad.py``.
"""

import os

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    CSVS22 as CSVS, case22_cfg, hold_to_jax, newton_counts, one_torch_thread,
    read_csv, strip_file)

MODES = {"lu": {}, "gmres": {"linear_solver": "gmres", "linear_rtol": 1e-12},
         "scan": {"scan_stepping": True}}
MOVES = [True, True, True, True, False, False]


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    return strip_file(tmp_path_factory.mktemp("mesh"), 3, 20, "triangle")


@pytest.fixture(scope="module")
def runs(strip, tmp_path_factory):
    """The JAX eager run (writing a checkpoint at t = 0.3) and the port's
    three paths (the host-LU run writing one at t = 0.4)."""
    from cmfem_tpu.apps import ablation_case2_2 as J
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    d = tmp_path_factory.mktemp("runs")
    out = {"dir": d, "jax": J.run(case22_cfg(
        strip, d / "jax", restart_write_file=str(d / "jax.chk"),
        restart_write_at_time=0.3, restart_write_at_end=False))}
    for mode, extra in MODES.items():
        if mode == "lu":
            extra = {**extra, "restart_write_file": str(d / "port.chk"),
                     "restart_write_at_time": 0.4,
                     "restart_write_at_end": False}
        out[mode] = P.run(case22_cfg(strip, d / mode, **extra), device="cpu")
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_case22_csvs_match_jax(runs, mode):
    d = runs["dir"]
    # the converged residuals and the last updates sit at GMRES's floor
    floor, newton_rtol = (1e-9, 1e-6) if mode == "gmres" else (1e-12, 1e-7)
    hold_to_jax(d / mode, d / "jax", floor=floor, newton_rtol=newton_rtol)
    port, jax_ = runs[mode], runs["jax"]
    assert port["newton_iters"] == newton_counts(d / "jax" / CSVS[3]) \
        and len(port["newton_iters"]) == 6
    assert port["converged"] and port["step"] == 6
    assert port["time"] == pytest.approx(jax_["time"], abs=1e-12)
    v = np.asarray(jax_["vertices"])
    assert np.abs(port["vertices"] - v).max() <= 1e-12 * np.abs(v).max()
    assert abs(port["recession_total"] - jax_["recession_total"]) <= \
        1e-8 * jax_["recession_total"]
    np.testing.assert_allclose(port["T"], jax_["T"], rtol=1e-9)
    np.testing.assert_allclose(port["p"], jax_["p"], rtol=1e-9)
    hist = np.asarray(port["recession_history"])
    np.testing.assert_allclose(hist, np.asarray(jax_["recession_history"]),
                               rtol=1e-8, atol=1e-300)
    for k, v in jax_["recession_metrics"].items():
        assert port["recession_metrics"][k] == pytest.approx(v, rel=1e-12)
    # the surface recedes from step 1 while blowing and stands still while
    # cooling, on the same steps in every path
    assert port["moved"] == MOVES
    assert (np.diff(hist[:, 1])[:4] > 0).all() and hist[1, 1] > 0
    assert (np.diff(hist[:, 1])[4:] == 0).all()
    _, mesh = read_csv(d / mode / "mesh_diagnostics.csv")
    assert (mesh[1:5, 3] > 0).all() and (mesh[5:, 3] == 0).all()
    _, mass = read_csv(d / mode / "mass_metrics.csv")
    assert (mass[1:5, 2] > 0).all() and (mass[5:, 2] == 0).all()
    np.testing.assert_array_equal(mass[:, 5], mesh[:, 4])


def test_eager_and_scan_paths_agree(runs):
    lu, scan = runs["lu"], runs["scan"]
    assert scan["linear_solver"] == "BlockTridiagDirect"
    v = lu["vertices"]
    # the scan path warm-starts the smoothing CG; the eager one starts
    # cold: the same velocities to the CG's tolerance
    assert np.abs(scan["vertices"] - v).max() <= 1e-12 * np.abs(v).max()
    assert abs(scan["recession_total"] - lu["recession_total"]) <= \
        1e-8 * lu["recession_total"]
    d = runs["dir"]
    for name in CSVS[:3] + CSVS[4:]:
        _, a = read_csv(d / "scan" / name)
        _, b = read_csv(d / "lu" / name)
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        scale = np.abs(b).max(axis=0)
        assert (np.abs(a - b) <= 1e-8 * np.abs(b) + 1e-12 * scale).all(), \
            name


def test_restart_crosses_the_packages(runs, strip, tmp_path):
    from cmfem_tpu.apps import ablation_case2_2 as J
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    d = runs["dir"]
    # the port resumes from the JAX checkpoint (t = 0.3) to the end, on
    # the receded mesh the checkpoint carries
    r = P.run(case22_cfg(strip, tmp_path,
                         restart_read_file=str(d / "jax.chk")),
              device="cpu")
    jax_ = runs["jax"]
    assert (r["step"], r["time"]) == (6, pytest.approx(0.6, abs=1e-12))
    np.testing.assert_allclose(r["T"], jax_["T"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(r["p"], jax_["p"], rtol=1e-7)
    v = np.asarray(jax_["vertices"])
    assert np.abs(r["vertices"] - v).max() <= 1e-12 * np.abs(v).max()
    assert r["recession_total"] == pytest.approx(jax_["recession_total"],
                                                 rel=1e-8)
    assert len(r["recession_history"]) == 7 and r["moved"] == MOVES[3:]
    # each package reads the other's checkpoint, with equal arrays
    fes = runs["lu"]["fes"]
    shape = (fes.nscalar,) + tuple(runs["lu"]["state"].extent.shape) \
        + tuple(fes.mesh.vertices.shape)
    for chk, t, step in ((d / "port.chk.npz", 0.4, 4),
                         (d / "jax.chk.npz", 0.3, 3)):
        a = J.load_restart_ale(str(chk), *shape)
        b = P.load_restart_ale(str(chk), *shape)
        assert (a[0], b[0]) == (step, step)
        assert a[1] == b[1] == pytest.approx(t, abs=1e-12)
        for x, y in zip(a[2:6], b[2:6]):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)
        assert a[6] == b[6] > 0 and a[7] == b[7] and len(a[7]) == step + 1
    with np.load(d / "port.chk.npz") as p_, np.load(d / "jax.chk.npz") as j_:
        assert set(p_.files) == set(j_.files)
        assert all(p_[k].dtype == j_[k].dtype for k in p_.files)
        # the port's t = 0.4 vertices are the JAX run's at t = 0.4: every
        # move after it stood still
        np.testing.assert_allclose(p_["vertices"], v, rtol=0,
                                   atol=1e-12 * np.abs(v).max())


def test_restart_guards_raise_as_jax(tmp_path):
    from cmfem_tpu.apps import ablation_case2_2 as J
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    T, p, X = np.arange(6.0), np.arange(6.0) + 10.0, np.zeros((2, 4, 3))
    V = np.ones((5, 2))
    good = str(tmp_path / "good.npz")
    P.save_restart_ale(good, 3, 0.3, torch.tensor(T), p, X, V, 1e-7,
                       [(0.0, 0.0), (0.3, 1e-7)],
                       elem_order="strip-row-major")
    cases = [({"version": np.uint32(1)}, (6, 2, 4, 3, 5, 2), "version"),
             ({"magic": np.uint64(7)}, (6, 2, 4, 3, 5, 2), "magic"),
             ({}, (6, 2, 4, 3, 6, 2), "vertex shape"),
             ({}, (6, 2, 4, 2, 5, 2), "reaction-state shape"),
             ({}, (7, 2, 4, 3, 5, 2), "true-dof size")]
    for i, (patch, shape, match) in enumerate(cases):
        path = good
        if patch:
            path = str(tmp_path / f"bad{i}.npz")
            with np.load(good) as dd:
                np.savez(path, **{**dict(dd), **patch})
        msgs = []
        for M in (J, P):
            with pytest.raises(ValueError, match=match) as e:
                M.load_restart_ale(path, *shape,
                                   elem_order="strip-row-major")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for M in (J, P):
        with pytest.raises(ValueError, match="element-order mismatch"):
            M.load_restart_ale(good, 6, 2, 4, 3, 5, 2)
    out = P.load_restart_ale(good[:-4], 6, 2, 4, 3, 5, 2,
                             elem_order="strip-row-major")
    assert out[:2] == (3, 0.3) and out[6:] == (1e-7, [(0.0, 0.0),
                                                      (0.3, 1e-7)])


@pytest.mark.parametrize("case", ["domain+blowing", "cooling"])
def test_jacobian_check_in_the_driver(runs, strip, tmp_path, capsys, case):
    """At step 1 the domain blocks (with the mesh velocity) pass and the
    blowing branch's face check is skipped (B'g = 0 clamps at a uniform
    p, as in 2.1); resumed from the port's t = 0.4 checkpoint, the cooling
    branch's face check passes on the receded mesh."""
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    extra = {"t_final": 0.1} if case == "domain+blowing" else {
        "t_final": 0.5, "restart_read_file": str(runs["dir"] / "port.chk")}
    r = P.run(case22_cfg(strip, tmp_path, jacobian_check=True, **extra),
              device="cpu")
    jc = r["jacobian_check"]
    out = capsys.readouterr().out
    if case == "domain+blowing":
        assert set(jc) == {"domain", "chemistry_blowing"} and r["moved"]
        assert jc["chemistry_blowing"] is None and 0.0 <= jc["domain"] < 1e-4
        assert "jacobian_check (domain blocks) passed" in out
    else:
        assert set(jc) == {"cooling_standard"} and r["step"] == 5
        assert 0.0 <= jc["cooling_standard"] < 1e-4
        assert "branch=cooling_standard) passed" in out


@pytest.mark.parametrize("study", [False, True], ids=["case2_2", "study"])
def test_main_runs_from_a_yaml_file(runs, strip, tmp_path, monkeypatch,
                                    capsys, study):
    """``main`` from a YAML file, 2 steps; the study variant's defaults
    turn the GCL storage on (the Jacobian-weighted, conservative storage
    terms), which changes the answer against the production driver's."""
    pytest.importorskip("yaml")
    from cmfem_tpu_torch.apps import ablation_case2_2, ablation_case2_2_test

    M = ablation_case2_2_test if study else ablation_case2_2
    seen = []
    real = ablation_case2_2.Case22.geometry
    monkeypatch.setattr(ablation_case2_2.Case22, "geometry",
                        lambda self, *a: seen.append(self.gcl_enabled)
                        or real(self, *a))
    cfg = case22_cfg(strip, tmp_path / "out", t_final=0.2)
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str)
                            else f"{k}: {v}\n" for k, v in cfg.items()))
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    assert M.main(["-i", str(path)]) == 0
    out = capsys.readouterr().out
    assert "step=2 t=0.2 [chemistry_blowing]" in out
    assert "Recession vs Amaryllis" in out
    for name in CSVS + ("recession_error_metrics.csv",):
        assert os.path.exists(tmp_path / "out" / name), name
    assert seen == [study] * 2
    assert ablation_case2_2_test.STUDY_DEFAULTS["gcl_storage_enabled"]
    _, probes = read_csv(tmp_path / "out" / CSVS[0])
    _, lu = read_csv(runs["dir"] / "lu" / CSVS[0])
    d = np.abs(probes[2] - lu[2]).max()
    assert (d > 1e-6) if study else (d <= 1e-9 * np.abs(lu[2]).max())


def test_run_refuses_what_it_does_not_do(strip, tmp_path, monkeypatch):
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    cfg = case22_cfg(strip, tmp_path)
    for extra, err, match in (
            ({"sharding_devices": 2, "dof_partition": 2}, ValueError,
             "sharding_devices and dof_partition are mutually exclusive"),
            ({"scan_stepping": True, "sharding_devices": 2},
             NotImplementedError,
             "scan_stepping and sharding_devices are mutually exclusive"),
            # the JAX scan path runs this on one device (ROADMAP, known
            # problem 10): the port refuses it
            ({"scan_stepping": True, "dof_partition": 2},
             NotImplementedError,
             "scan_stepping and dof_partition are mutually exclusive"),
            ({"scan_stepping": True, "order": 2}, NotImplementedError,
             "order 1"),
            ({"scan_stepping": True, "restart_read_file": "x"},
             NotImplementedError, "restart I/O"),
            ({"scan_stepping": True, "restart_write_file": "x"},
             NotImplementedError, "restart I/O"),
            ({"scan_stepping": True, "jacobian_check": True},
             NotImplementedError, "eager path"),
            ({"mesh_smoothing_model": "elastic"}, ValueError, "laplacian")):
        with pytest.raises(err, match=match):
            P.run({**cfg, **extra}, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        P.run(cfg, device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run(cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lu", "scan"])
def test_cuda_case22_step_equals_cpu(strip, tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.apps import ablation_case2_2 as P

    out = {dev: P.run(case22_cfg(strip, tmp_path / dev, t_final=0.2,
                                 **MODES[mode]), device=dev)
           for dev in ("cpu", "cuda")}
    assert out["cuda"]["newton_iters"] == out["cpu"]["newton_iters"]
    assert out["cuda"]["moved"] == out["cpu"]["moved"] == [True, True]
    np.testing.assert_allclose(out["cuda"]["T"], out["cpu"]["T"], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"]["p"], out["cpu"]["p"], rtol=1e-9)
    v = out["cpu"]["vertices"]
    assert np.abs(out["cuda"]["vertices"] - v).max() <= \
        1e-12 * np.abs(v).max()
    assert out["cuda"]["recession_total"] == pytest.approx(
        out["cpu"]["recession_total"], rel=1e-8)
