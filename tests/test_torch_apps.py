"""Port parity, the application drivers: ``diffusion_mms``, ``linear_cd_2d``,
``linear_cd_2d_circle`` and ``linear_cd_transient`` of both packages run the
same ``cfg`` on a GMSH file the test writes (8 x 8 quads, 8 x 8 x 2 triangles,
the square mapped onto the unit disc), float64 on the CPU: the CSV headers are
equal, every CSV value agrees to rtol 1e-7, the solution to 1e-9 of max|u|,
and the VTU/PVD file names are the same.  ``linear_solver: mg``, ``sdirk2``
and ``scan_stepping`` included; the port's ``scan_stepping`` loop against its
host loop to 1e-10; ``main(["-i", yaml])`` from a YAML the test writes; and
``run(cfg)`` with no device raises without CUDA instead of taking the CPU."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import disc_mesh  # noqa: E402

from cmfem_tpu_torch.core import make_cartesian_mesh_2d, write_gmsh  # noqa: E402

DRIVERS = ["diffusion_mms", "linear_cd_2d", "linear_cd_2d_circle",
           "linear_cd_transient"]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    return {
        "quad": write_gmsh(make_cartesian_mesh_2d(8, 8), str(d / "quad.msh")),
        "quad4": write_gmsh(make_cartesian_mesh_2d(4, 4), str(d / "q4.msh")),
        "tri": write_gmsh(make_cartesian_mesh_2d(8, 8, geom="triangle"),
                          str(d / "tri.msh")),
        "tri4": write_gmsh(make_cartesian_mesh_2d(4, 4, geom="triangle"),
                           str(d / "t4.msh")),
        "disc": write_gmsh(disc_mesh(8), str(d / "disc.msh")),
    }


def _read_csv(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _run_both(name, cfg, tmp_path):
    out = {}
    for pkg in ("cmfem_tpu", "cmfem_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.apps.{name}")
        c = dict(cfg, output_path=str(tmp_path / pkg))
        out[pkg] = mod.run(c) if pkg == "cmfem_tpu" \
            else mod.run(c, device="cpu")
    return out["cmfem_tpu"], out["cmfem_tpu_torch"]


def _compare(tmp_path, rj, rt, field="u", csv=None):
    pj, pt = str(tmp_path / "cmfem_tpu"), str(tmp_path / "cmfem_tpu_torch")
    files = _files(pt)
    assert files == _files(pj)
    csvs = [f for f in files if f.endswith(".csv")]
    assert csvs == ([csv] if csv else csvs) and len(csvs) == 1
    assert any(f.endswith(".pvd") for f in files)
    assert any(f.endswith(".vtu") for f in files)
    hj, vj = _read_csv(os.path.join(pj, csvs[0]))
    ht, vt = _read_csv(os.path.join(pt, csvs[0]))
    assert ht == hj and vt.shape == vj.shape and len(vt) >= 1
    np.testing.assert_allclose(vt, vj, rtol=1e-7, atol=1e-15)
    uj, ut = np.asarray(rj[field]), np.asarray(rt[field])
    assert ut.shape == uj.shape and ut.dtype == np.float64
    np.testing.assert_allclose(ut, uj, rtol=0,
                               atol=1e-9 * np.abs(uj).max())
    assert rt["fes"].nscalar == rj["fes"].nscalar
    return vt


@pytest.mark.parametrize("mesh,extra", [
    ("quad", {}),
    ("tri", {"order": 3, "mode_n": 1, "mode_m": 2, "convection": [0.5, 0.25],
             "kappa": 1.0, "s": 0.0}),
    # multigrid on a diffusion-dominated form (Chebyshev smoothing assumes a
    # nearly symmetric operator)
    ("tri4", {"linear_solver": "mg", "serial_ref_levels": 1, "kappa": 1.0,
              "convection": [0.2, -0.1], "mode_n": 1, "mode_m": 1}),
])
def test_linear_cd_2d_matches_jax(meshes, tmp_path, mesh, extra):
    cfg = {"mesh_file": meshes[mesh], "order": 2, **extra}
    rj, rt = _run_both("linear_cd_2d", cfg, tmp_path)
    vals = _compare(tmp_path, rj, rt, csv="error_history_2D.csv")
    assert rt["solve"].converged and 0 < vals[0, 1] < 0.05
    np.testing.assert_allclose(rt["rel_l2"], rj["rel_l2"], rtol=1e-7)


@pytest.mark.parametrize("order", [1, 2])
def test_linear_cd_2d_circle_matches_jax(meshes, tmp_path, order):
    cfg = {"mesh_file": meshes["disc"], "order": order,
           "collection_name": "disc", "error_csv": "disc.csv"}
    rj, rt = _run_both("linear_cd_2d_circle", cfg, tmp_path)
    vals = _compare(tmp_path, rj, rt, csv="disc.csv")
    assert rt["solve"].converged and 0 < vals[0, 1] < 0.5
    # collection_name names the ParaView collection
    assert any(f.endswith("disc.pvd")
               for f in _files(str(tmp_path / "cmfem_tpu_torch")))


@pytest.mark.parametrize("mesh,extra", [
    ("tri", {}),
    ("tri", {"time_integrator": "sdirk2"}),
    ("quad4", {"time_integrator": "sdirk3", "order": 1}),
    ("tri4", {"linear_solver": "mg", "serial_ref_levels": 1}),
])
def test_diffusion_mms_matches_jax(meshes, tmp_path, mesh, extra):
    cfg = {"mesh_file": meshes[mesh], "order": 2, "dt": 0.01, "t_final": 0.03,
           "alpha": 0.5, "paraview_every": 2, **extra}
    rj, rt = _run_both("diffusion_mms", cfg, tmp_path)
    vals = _compare(tmp_path, rj, rt, csv="error_history.csv")
    assert len(vals) == 4 and rt["converged"]
    assert rt["solve_iters"] == rj["solve_iters"]
    assert 0 < rt["final_l2"] < 1e-3
    assert len(rt["timing"]) == 3 and rt["timing"][0]["solve"] > 0


@pytest.mark.parametrize("extra", [
    {},
    {"scan_stepping": True},
    {"time_integrator": "sdirk2"},
    {"linear_solver": "mg", "serial_ref_levels": 1, "mesh": "quad4"},
])
def test_linear_cd_transient_matches_jax(meshes, tmp_path, extra):
    extra = dict(extra)
    cfg = {"mesh_file": meshes[extra.pop("mesh", "quad")], "order": 2,
           "dt": 0.01, "t_final": 0.03, "peclet": [1.0, 10.0, 50.0],
           "paraview_every": 2, **extra}
    rj, rt = _run_both("linear_cd_transient", cfg, tmp_path)
    vals = _compare(tmp_path, rj, rt, field="c", csv="error_history.csv")
    assert vals.shape == (4, 8) and rt["converged"]
    np.testing.assert_allclose(rt["final_errors"], rj["final_errors"],
                               rtol=1e-7)
    assert len(rt["arnoldi"]) == 9 * (2 if "time_integrator" in extra else 1)


def test_scan_stepping_equals_host_loop(meshes, tmp_path):
    from cmfem_tpu_torch.apps import linear_cd_transient as app

    cfg = {"mesh_file": meshes["tri"], "order": 1, "dt": 0.005,
           "t_final": 0.025, "save_paraview": False}
    host = app.run(dict(cfg, output_path=str(tmp_path / "host")),
                   device="cpu")
    scan = app.run(dict(cfg, output_path=str(tmp_path / "scan"),
                        scan_stepping=True), device="cpu")
    hh, vh = _read_csv(str(tmp_path / "host" / "error_history.csv"))
    hs, vs = _read_csv(str(tmp_path / "scan" / "error_history.csv"))
    assert hh == hs and vh.shape == vs.shape == (6, 8)
    np.testing.assert_allclose(vs, vh, rtol=0, atol=1e-10)
    np.testing.assert_allclose(scan["c"], host["c"], rtol=0, atol=1e-10)
    assert _files(str(tmp_path / "scan")) == ["error_history.csv"]


@pytest.mark.parametrize("name", DRIVERS)
def test_main_runs_from_a_yaml_file(meshes, tmp_path, monkeypatch, capsys,
                                    name):
    yaml = pytest.importorskip("yaml")
    mesh = "disc" if name == "linear_cd_2d_circle" else "quad4"
    cfg = {"mesh_file": os.path.basename(meshes[mesh]), "order": 1,
           "dt": 0.01, "t_final": 0.02, "output_path": str(tmp_path / "out"),
           "save_paraview": False}
    # the mesh path is relative: resolved against the YAML's directory
    deck = os.path.join(os.path.dirname(meshes[mesh]), f"{name}.yaml")
    with open(deck, "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    assert mod.main(["-i", deck]) == 0
    out = capsys.readouterr().out
    assert "Loaded configuration:" in out and "Global true dofs:" in out
    assert "_yaml_dir" not in out
    assert [f for f in _files(str(tmp_path / "out")) if f.endswith(".csv")]


@pytest.mark.parametrize("name", DRIVERS)
def test_run_without_a_device_requires_cuda(meshes, tmp_path, monkeypatch,
                                            name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    cfg = {"mesh_file": meshes["quad4"], "output_path": str(tmp_path / "o")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(cfg)
    # main() takes the CPU only when CMFEM_FORCE_CPU=1 asks for it
    pytest.importorskip("yaml")
    deck = tmp_path / "deck.yaml"
    deck.write_text(f"mesh_file: {meshes['quad4']}\n"
                    f"output_path: {tmp_path / 'o'}\n")
    monkeypatch.delenv("CMFEM_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["-i", str(deck)])
    assert not os.path.exists(tmp_path / "o")


def test_importing_the_apps_needs_no_yaml(monkeypatch):
    """``import yaml`` happens inside ``load_yaml`` only."""
    import subprocess

    code = ("import sys; sys.modules['yaml'] = None\n"
            "import cmfem_tpu_torch.apps.common\n"
            + "".join(f"import cmfem_tpu_torch.apps.{n}\n" for n in DRIVERS)
            + "import cmfem_tpu_torch.utils, cmfem_tpu_torch.io\n"
            "print('imported')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "imported" in proc.stdout, proc.stderr


def test_float32_run_stays_near_float64(meshes, tmp_path):
    """A caller who asks for float32 gets the working-precision floor
    accepted by ``check_standalone_linear`` and an answer within 1e-4 of the
    float64 one (relative to max|u|)."""
    from cmfem_tpu_torch.apps import linear_cd_2d as app

    cfg = {"mesh_file": meshes["quad4"], "order": 2, "save_paraview": False}
    r64 = app.run(dict(cfg, output_path=str(tmp_path / "a")), device="cpu")
    r32 = app.run(dict(cfg, output_path=str(tmp_path / "b")), device="cpu",
                  dtype=torch.float32)
    assert r32["u"].dtype == np.float32
    assert np.abs(r32["u"] - r64["u"]).max() <= 1e-4 * np.abs(r64["u"]).max()


def test_validation_errors_are_the_jax_drivers(meshes, tmp_path):
    from cmfem_tpu_torch.apps import (
        diffusion_mms, linear_cd_2d, linear_cd_2d_circle, linear_cd_transient,
    )

    base = {"mesh_file": meshes["quad4"], "output_path": str(tmp_path / "o")}
    with pytest.raises(ValueError, match="unit-circle"):
        linear_cd_2d_circle.run(base, device="cpu")
    with pytest.raises(ValueError, match=r"\[0,1\]x\[0,1\]"):
        linear_cd_2d.run(dict(base, mesh_file=meshes["disc"]), device="cpu")
    with pytest.raises(ValueError, match="exactly 3"):
        linear_cd_transient.run(dict(base, peclet=[1.0]), device="cpu")
    with pytest.raises(ValueError, match="linear_solver"):
        diffusion_mms.run(dict(base, linear_solver="amg"), device="cpu")
    with pytest.raises(KeyError, match="mesh_file"):
        diffusion_mms.run({}, device="cpu")
    with pytest.raises(ValueError, match="unknown time integrator"):
        diffusion_mms.run(dict(base, time_integrator="rk4"), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["diffusion_mms", "linear_cd_transient"])
def test_cuda_driver_step_equals_cpu(meshes, tmp_path, name):
    """One driver step on the CUDA device against the same step on the CPU,
    float64: 1e-10 of max|u|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    cfg = {"mesh_file": meshes["tri"], "order": 2, "dt": 0.01,
           "t_final": 0.01, "save_paraview": False}
    cpu = mod.run(dict(cfg, output_path=str(tmp_path / "cpu")), device="cpu")
    gpu = mod.run(dict(cfg, output_path=str(tmp_path / "gpu")))
    key = "u" if name == "diffusion_mms" else "c"
    assert gpu["converged"]
    np.testing.assert_allclose(gpu[key], cpu[key], rtol=0,
                               atol=1e-10 * np.abs(cpu[key]).max())
    _, vc = _read_csv(str(tmp_path / "cpu" / "error_history.csv"))
    _, vg = _read_csv(str(tmp_path / "gpu" / "error_history.csv"))
    np.testing.assert_allclose(vg, vc, rtol=1e-7, atol=1e-15)
