"""Port parity, the application drivers: ``diffusion_mms``, ``linear_cd_2d``,
``linear_cd_2d_circle``, ``linear_cd_transient``, ``nonlinear_diffusion``,
``elasticity``, ``diffusion_mms_ale`` and ``qstar_blowing_1d`` of both
packages run the same ``cfg`` on a GMSH file the test writes (8 x 8 quads,
8 x 8 x 2 triangles, the square mapped onto the unit disc, 8 x 8 quads of
side 0.01) or a generated mesh, float64 on the CPU: the CSV headers are
equal, every CSV value agrees to rtol 1e-7, the solution to 1e-9 of max|u|,
the Newton, CG and GMRES counts are equal where the JAX driver reports them,
and the VTU/PVD file names are the same.  ``linear_solver: mg``, ``sdirk2``
and ``scan_stepping`` included; the port's ``scan_stepping`` loop against its
host loop to 1e-10; the ALE driver's identity map against ``diffusion_mms``
to 1e-8; ``main`` from a YAML (or the Q* arguments) the test writes; and
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
ALL_DRIVERS = DRIVERS + ["nonlinear_diffusion", "elasticity",
                         "diffusion_mms_ale", "qstar_blowing_1d"]


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
        "square_0p01": write_gmsh(make_cartesian_mesh_2d(8, 8, sx=0.01,
                                                         sy=0.01),
                                  str(d / "sq.msh")),
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
            + "".join(f"import cmfem_tpu_torch.apps.{n}\n" for n in ALL_DRIVERS)
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


# -- slice 7: the nonlinear, vector and ALE drivers and Q* ------------------

def _compare_csvs(tmp_path, names, floors=None):
    """Every named CSV of both runs: equal headers, values to rtol 1e-7.
    ``floors`` maps (name, column) to an absolute tolerance for a column
    that holds values at the roundoff floor (a converged Newton residual)."""
    out = {}
    for name in names:
        hj, vj = _read_csv(str(tmp_path / "cmfem_tpu" / name))
        ht, vt = _read_csv(str(tmp_path / "cmfem_tpu_torch" / name))
        assert ht == hj and vt.shape == vj.shape and len(vt) >= 1, name
        atol = np.full(vt.shape[1], 1e-15)
        for (n, col), tol in (floors or {}).items():
            if n == name:
                atol[hj.index(col)] = tol
        assert (np.abs(vt - vj) <= atol + 1e-7 * np.abs(vj)).all(), \
            (name, vt, vj)
        out[name] = vt
    return out


def _close_u(ut, uj):
    uj, ut = np.asarray(uj), np.asarray(ut)
    assert ut.shape == uj.shape and ut.dtype == np.float64
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-9 * np.abs(uj).max())


def test_nonlinear_diffusion_matches_jax(meshes, tmp_path):
    cfg = {"mesh_file": meshes["square_0p01"], "order": 2, "dt": 0.1,
           "t_final": 0.2, "L": 0.01, "series_terms": 400,
           "newton_print_level": 0}
    rj, rt = _run_both("nonlinear_diffusion", cfg, tmp_path)
    assert _files(str(tmp_path / "cmfem_tpu_torch")) == \
        _files(str(tmp_path / "cmfem_tpu"))
    # the residual and the update at the last Newton iterations (1e-8 to
    # 1e-14 of the step's first) are decided by roundoff in the residual's
    # cancellation (terms of 1e4 times its size): those columns are held to
    # rtol 1e-7 or 1e-12 of the column's largest value, the rest to rtol 1e-7
    name = "newton_history_nonlinear_1D.csv"
    h, vals = _read_csv(str(tmp_path / "cmfem_tpu" / name))
    floors = {(name, c): 1e-12 * np.abs(vals[:, h.index(c)]).max()
              for c in ("residual", "rel_residual", "update_norm",
                        "rel_update")}
    floors["error_history_nonlinear_1D.csv", "final_residual"] = \
        floors[name, "residual"]
    v = _compare_csvs(tmp_path, ["error_history_nonlinear_1D.csv",
                                 "newton_history_nonlinear_1D.csv"], floors)
    err, newton = v["error_history_nonlinear_1D.csv"], \
        v["newton_history_nonlinear_1D.csv"]
    # equal Newton counts: the newton_iters column and the Newton rows
    assert list(err[1:, 4]) == rt["newton_iters"] and len(newton) == \
        sum(n + 1 for n in rt["newton_iters"])
    _close_u(rt["u"], rj["u"])
    np.testing.assert_allclose(rt["final"], rj["final"], rtol=1e-7)
    assert rt["converged"] and 0 < rt["final"][1] < 2e-2
    assert [len(k) for k in rt["krylov_iters"]] == rt["newton_iters"]
    assert len(rt["timing"]) == 2 and rt["timing"][0]["jacobian"] > 0


@pytest.mark.parametrize("dim,n", [(2, (20, 4, 1)), (3, (8, 2, 2))])
def test_elasticity_matches_jax(tmp_path, dim, n):
    """CG to solver_rtol 1e-8: there both packages take the same number of
    iterations.  Nearer the floor of these slender beams (rtol 1e-9, 1e-10)
    the count is decided by roundoff, and 20 x 2 stops in both packages' CG
    on its flat-window exit."""
    cfg = {"dim": dim, "order": 2, "nx": n[0], "ny": n[1], "nz": n[2],
           "solver_rtol": 1e-8}
    rj, rt = _run_both("elasticity", cfg, tmp_path)
    assert _files(str(tmp_path / "cmfem_tpu_torch")) == \
        _files(str(tmp_path / "cmfem_tpu"))
    rows = {}
    for pkg in ("cmfem_tpu", "cmfem_tpu_torch"):
        with open(tmp_path / pkg / "elasticity_summary.csv") as f:
            lines = f.read().split()
        rows[pkg] = [r.split(",") for r in lines]
    assert [r[0] for r in rows["cmfem_tpu_torch"]] == \
        [r[0] for r in rows["cmfem_tpu"]]
    np.testing.assert_allclose(
        [float(r[1]) for r in rows["cmfem_tpu_torch"][1:]],
        [float(r[1]) for r in rows["cmfem_tpu"][1:]], rtol=1e-7)
    _close_u(rt["u"], rj["u"])
    assert rt["iters"] == rj["iters"] and rt["converged"]
    np.testing.assert_allclose(rt["tip_deflection"], rj["tip_deflection"],
                               rtol=1e-9)


@pytest.mark.parametrize("ale_map", ["accuracy_a", "identity"])
def test_diffusion_mms_ale_matches_jax(meshes, tmp_path, ale_map):
    cfg = {"mesh_file": meshes["tri"], "order": 1, "alpha": 0.1, "dt": 0.05,
           "t_final": 0.1, "ale_map": ale_map, "paraview_every": 2}
    rj, rt = _run_both("diffusion_mms_ale", cfg, tmp_path)
    _compare(tmp_path, rj, rt, csv="error_history.csv")
    np.testing.assert_allclose(rt["final_l2"], rj["final_l2"], rtol=1e-7)
    assert rt["converged"] and len(rt["krylov_iters"]) == 2
    assert 0 < rt["final_l2"] < 2e-2


def test_ale_identity_equals_diffusion_mms(meshes, tmp_path):
    """The JAX package's own A/B fixture (tests/test_ale.py): the identity
    map reproduces the static MMS driver, in the port."""
    from cmfem_tpu_torch.apps import diffusion_mms, diffusion_mms_ale

    base = dict(mesh_file=meshes["tri"], order=1, alpha=0.1, dt=0.05,
                t_final=0.15, save_paraview=False)
    oa = diffusion_mms_ale.run({**base, "ale_map": "identity",
                                "output_path": str(tmp_path / "ale")},
                               device="cpu")
    os_ = diffusion_mms.run({**base, "output_path": str(tmp_path / "mms")},
                            device="cpu")
    assert np.abs(oa["u"] - os_["u"]).max() < 1e-8


def test_qstar_blowing_1d_matches_jax(tmp_path):
    from cmfem_tpu.apps import qstar_blowing_1d as jq
    from cmfem_tpu_torch.apps import qstar_blowing_1d as tq

    out = {}
    for pkg, mod in (("cmfem_tpu", jq), ("cmfem_tpu_torch", tq)):
        p = mod.QstarParams(num_elements=64, verbose=False,
                            output_dir=str(tmp_path / pkg))
        out[pkg] = mod.run(p) if mod is jq else mod.run(p, device="cpu")
    rj, rt = out["cmfem_tpu"], out["cmfem_tpu_torch"]
    _compare_csvs(tmp_path, ["qstar_blowing_profile.csv",
                             "qstar_blowing_summary.csv"])
    assert rt["converged"] and rt["iterations"] == rj["iterations"]
    np.testing.assert_allclose(rt["sdot"], rj["sdot"], rtol=1e-10)
    np.testing.assert_allclose(rt["T"], rj["T"], rtol=1e-10)
    np.testing.assert_allclose(rt["dTdx0"], rj["dTdx0"], rtol=1e-7)
    assert abs(rt["sdot_rel_error"]) < 1e-2  # 7.4e-3 at N = 64


def test_qstar_blowing_phi_and_its_tangent():
    """phi against the JAX driver's on both branches; at sdot = 0 the series
    branch is taken and the forward-mode tangent through the untaken
    xi/expm1(xi) branch stays finite (its xi_safe guard); elsewhere the
    tangent is the central difference; a Newton cap of 0 raises."""
    from torch.func import jacfwd
    from cmfem_tpu_torch.apps import qstar_blowing_1d as tq

    p = tq.QstarParams()
    phi = lambda s: tq.blowing_phi(p, s)[0]
    for s in (0.0, 1e-14, 1e-5, 2e-4):
        st = torch.tensor(s, dtype=torch.float64)
        xi = 2.0 * p.lam * p.rho * s / p.rhoe_ue_Ch0
        ref = 1.0 - 0.5 * xi if xi < 1e-8 else xi / np.expm1(xi)
        np.testing.assert_allclose(float(phi(st)), ref, rtol=1e-14)
        d = float(jacfwd(phi)(st))
        assert np.isfinite(d)
        if s > 1e-6:
            h = 1e-9
            fd = (float(phi(st + h)) - float(phi(st - h))) / (2 * h)
            np.testing.assert_allclose(d, fd, rtol=1e-5)
    with pytest.raises(RuntimeError, match="did not converge"):
        tq.run(tq.QstarParams(num_elements=8, verbose=False,
                              newton_max_iter=0), device="cpu")


@pytest.mark.parametrize("name", ["nonlinear_diffusion", "diffusion_mms_ale",
                                  "elasticity"])
def test_main_runs_new_drivers_from_a_yaml_file(meshes, tmp_path, monkeypatch,
                                                capsys, name):
    yaml = pytest.importorskip("yaml")
    cfg = {"order": 1, "dt": 0.05, "t_final": 0.05,
           "output_path": str(tmp_path / "out"), "save_paraview": False,
           "newton_print_level": 0}
    if name == "elasticity":
        cfg.update(nx=8, ny=2)
    else:
        cfg["mesh_file"] = os.path.basename(
            meshes["square_0p01" if name == "nonlinear_diffusion" else "tri"])
        if name == "nonlinear_diffusion":
            cfg.update(dt=0.1, t_final=0.1, L=0.01)
    deck = os.path.join(os.path.dirname(meshes["tri"]), f"{name}.yaml")
    with open(deck, "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    assert mod.main(["-i", deck]) == 0
    out = capsys.readouterr().out
    assert "Loaded configuration:" in out and "dofs:" in out
    assert [f for f in _files(str(tmp_path / "out")) if f.endswith(".csv")]


def test_qstar_main_honours_force_cpu(tmp_path, monkeypatch, capsys):
    from cmfem_tpu_torch.apps import qstar_blowing_1d as tq

    args = ["--num-elements", "16", "--quiet", "--output-dir",
            str(tmp_path / "q")]
    monkeypatch.setenv("CMFEM_FORCE_CPU", "1")
    assert tq.main(args) == 0
    assert "Converged solution" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "q" / "qstar_blowing_summary.csv")
    if not torch.cuda.is_available():
        monkeypatch.delenv("CMFEM_FORCE_CPU")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.main(args)


@pytest.mark.parametrize("name", ["nonlinear_diffusion", "elasticity",
                                  "diffusion_mms_ale", "qstar_blowing_1d"])
def test_new_driver_without_a_device_requires_cuda(meshes, tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    arg = mod.QstarParams(output_dir=str(tmp_path / "o")) \
        if name == "qstar_blowing_1d" else \
        {"mesh_file": meshes["quad4"], "output_path": str(tmp_path / "o")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(arg)
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nonlinear_diffusion", "elasticity",
                                  "diffusion_mms_ale", "qstar_blowing_1d"])
def test_cuda_new_driver_equals_cpu(meshes, tmp_path, name):
    """A short run of each slice-7 driver on the CUDA device against the same
    run on the CPU, float64: solution to 1e-10 of max|u|, equal counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{name}")
    if name == "qstar_blowing_1d":
        mk = lambda d: mod.QstarParams(num_elements=64, verbose=False,
                                       output_dir=str(tmp_path / d))
        cpu, gpu = mod.run(mk("cpu"), device="cpu"), mod.run(mk("gpu"))
        assert gpu["iterations"] == cpu["iterations"]
        np.testing.assert_allclose(gpu["sdot"], cpu["sdot"], rtol=1e-10)
        return
    cfg = {"save_paraview": False, "newton_print_level": 0}
    if name == "nonlinear_diffusion":
        cfg.update(mesh_file=meshes["square_0p01"], order=2, dt=0.1,
                   t_final=0.1, L=0.01)
    elif name == "diffusion_mms_ale":
        cfg.update(mesh_file=meshes["tri"], order=1, dt=0.05, t_final=0.05)
    else:  # CG counts agree across devices to this rtol (see above)
        cfg.update(dim=3, nx=8, ny=2, nz=2, solver_rtol=1e-8)
    cpu = mod.run(dict(cfg, output_path=str(tmp_path / "cpu")), device="cpu")
    gpu = mod.run(dict(cfg, output_path=str(tmp_path / "gpu")))
    assert gpu["converged"]
    np.testing.assert_allclose(gpu["u"], cpu["u"], rtol=0,
                               atol=1e-10 * np.abs(cpu["u"]).max())
    for key in ("newton_iters", "iters"):
        assert gpu.get(key) == cpu.get(key)
