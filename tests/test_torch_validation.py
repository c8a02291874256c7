"""Port parity, ``validation/``: each harness and plotter of
``cmfem_tpu_torch.validation`` against the JAX package's copy on the same
inputs, CSVs the port's drivers write on the CPU: cases 1, 2.1 and 2.2 on
a 3 x 20 strip (6 steps of dt 0.1, the synthetic deck and schedule), the
Q* driver at 512 elements, and reference histories written here from them
(FIAT and Amaryllis tables of the reference's column layouts; synthetic,
not validation data).  The metrics CSVs the harnesses write are equal as
text, their returned flags equal; the generated material YAML is equal as
text; the plotters write the same PNG files; the ALE sweep through each
package's ``diffusion_mms_ale`` writes the same CSV layout with the
numbers to 1e-7.  Importing the package loads no matplotlib."""

import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, SCHED, TOP, case22_cfg, one_torch_thread, read_csv,
    strip_file)

PROBE_Y = [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034, 0.026]
INPUT_YAML = ("probe_y: [" + ", ".join(str(y) for y in PROBE_Y) + "]\n"
              "acceptance:\n  temperature_rmse_max: 40.0\n"
              "  m_dot_g_rmse_max: 0.5\n  bogus: not_a_number\n")


def pkgs(module):
    """(JAX package's module, port's module)."""
    return tuple(importlib.import_module(f"{p}.validation.{module}")
                 for p in ("cmfem_tpu", "cmfem_tpu_torch"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's driver outputs: case 1, 2.1 and 2.2 (6 steps) and Q*."""
    from cmfem_tpu_torch.apps import (ablation_case1, ablation_case2_1,
                                      ablation_case2_2, qstar_blowing_1d)

    d = tmp_path_factory.mktemp("runs")
    strips = {g: strip_file(d, 3, 20, geom=g) for g in ("quad", "triangle")}
    base = {"material_file": FIXTURE, "order": 1, "dt": 0.1, "t_final": 0.6,
            "bdr_attr_top": TOP, "probe_x": 0.00125,
            "newton_print_level": 0, "save_paraview": False,
            "probe_y": PROBE_Y}
    ablation_case1.run({**base, "mesh_file": strips["quad"],
                        "output_path": str(d / "c1")}, device="cpu")
    ablation_case2_1.run({**base, "mesh_file": strips["quad"],
                          "boundary_conditions_file": SCHED,
                          "output_path": str(d / "c21")}, device="cpu")
    ablation_case2_2.run({**case22_cfg(strips["triangle"], d / "c22"),
                          "probe_y": PROBE_Y}, device="cpu")
    qstar_blowing_1d.run(qstar_blowing_1d.QstarParams(
        num_elements=512, verbose=False, output_dir=str(d / "q")),
        device="cpu")
    (d / "input.yaml").write_text(INPUT_YAML)
    return d


def _both_dirs(src, tmp_path):
    """Two copies of a run directory, one per package."""
    out = []
    for name in ("jax", "port"):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def _strip_paths(res):
    return {k: v for k, v in res.items() if k != "metrics_csv"}


def test_import_loads_no_matplotlib():
    code = ("import sys; import cmfem_tpu_torch.validation.plots, "
            "cmfem_tpu_torch.validation.compare_case2, "
            "cmfem_tpu_torch.validation.compare_case1, "
            "cmfem_tpu_torch.validation.compare_qstar, "
            "cmfem_tpu_torch.validation.generate_material; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('matplotlib', 'jax', 'cmfem_tpu.'))))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_common_functions_match_jax(runs, tmp_path):
    J, P = pkgs("common")
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    t = np.linspace(0.0, 1.0, 50)
    assert P.rmse(a, b) == J.rmse(a, b)
    assert P.max_abs(a, b) == J.max_abs(a, b)
    for args in ((t, a, b, 0.2, 0.7), (t, a, b, 0.2, 0.7, a > 0),
                 (t, a, b, 2.0, 3.0)):
        np.testing.assert_array_equal(P.segmented_rmse_max(*args),
                                      J.segmented_rmse_max(*args))
    yml = runs / "input.yaml"
    assert P.load_acceptance_from_yaml(yml, {"x": 1.0}) == \
        J.load_acceptance_from_yaml(yml, {"x": 1.0})
    assert P.load_probe_depths_from_yaml(yml) == \
        J.load_probe_depths_from_yaml(yml)
    assert P.load_probe_depths_from_yaml(tmp_path / "absent.yaml") == []
    probes = np.genfromtxt(runs / "c1" / "temperature_probes.csv",
                           delimiter=",", names=True)
    depths = P.load_probe_depths_from_yaml(yml)
    for fn in ("temperature_by_depth_from_probes",):
        got, want = (getattr(m, fn)(probes, depths) for m in (P, J))
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])
    table = np.column_stack([probes["time"], probes["wall"], probes["TC1"]])
    got = P.temperature_by_depth_from_reference(table, depths)
    want = J.temperature_by_depth_from_reference(table, depths)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    # a PATO point plot: header names the probes by position
    pato = tmp_path / "p"
    pato.write_text("// time probe0(0.001,0.05,0) probe1(0.001,0.049,0) "
                    "probe2(0.001,0.01,0)\n"
                    + "".join(f"{t:g} {1e5 + t} {2e5 + t} {3e5}\n"
                              for t in (0.0, 0.1, 0.2)))
    (tp, vp, yp), (tj, vj, yj) = (m.load_pato_point_plot(pato)
                                  for m in (P, J))
    np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(vp, vj)
    assert yp == yj == [0.05, 0.049, 0.01]
    names = ["wall", "TC1", "TC2"]
    series = {n: np.full(3, i) for i, n in enumerate(names)}
    got = P.match_probes_by_y(names, series, [0.05, 0.049, 0.05], yp)
    want = J.match_probes_by_y(names, series, [0.05, 0.049, 0.05], yj)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    rows = [["a", "b", 1.5, 2, "", "", "", 1]]
    P.write_metrics_csv(tmp_path / "p.csv", rows)
    J.write_metrics_csv(tmp_path / "j.csv", rows)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    np.testing.assert_array_equal(P.ensure_2d(a), J.ensure_2d(a))


def _fiat_tables(run_dir, tmp_path):
    """Synthetic FIAT T (time, wall, TC1..) and pyrolysisFront (9 columns:
    2 = mass flux, 7 = 2% char, 8 = 98% virgin) tables from a case-1 run,
    offset so that the metrics are not zero."""
    _, probes = read_csv(run_dir / "temperature_probes.csv")
    _, mass = read_csv(run_dir / "mass_metrics.csv")
    t = probes[:, 0]
    T = probes.copy()
    T[:, 1:] += 10.0 * np.sin(7.0 * t)[:, None]
    front = np.zeros((len(mass), 9))
    front[:, 0] = mass[:, 0]
    front[:, 2] = 1.1 * mass[:, 1]
    front[:, 7] = mass[:, 4] + 1e-4
    front[:, 8] = mass[:, 3] - 1e-4
    np.savetxt(tmp_path / "fiat_T", T)
    np.savetxt(tmp_path / "fiat_front", front)
    return tmp_path / "fiat_T", tmp_path / "fiat_front"


@pytest.mark.parametrize("plots", [False, True])
def test_compare_case1_matches_jax(runs, tmp_path, plots):
    J, P = pkgs("compare_case1")
    fT, ff = _fiat_tables(runs / "c1", tmp_path)
    dj, dp = _both_dirs(runs / "c1", tmp_path)
    rj = J.compare(dj, runs / "input.yaml", fT, ff, make_plots=plots)
    rp = P.compare(dp, runs / "input.yaml", fT, ff, make_plots=plots)
    assert _strip_paths(rp) == _strip_paths(rj)
    name = "fiat_error_metrics.csv"
    assert (dp / name).read_text() == (dj / name).read_text()
    pngs = sorted(p.name for p in dp.glob("*.png"))
    assert pngs == sorted(p.name for p in dj.glob("*.png"))
    assert len(pngs) == (3 if plots else 0)


def _amaryllis_tables(run_dir, tmp_path, case):
    """Synthetic Amaryllis energy (time, wall, TC1..) and mass (time,
    m_dot_g, m_dot_c, front98, front2, recession) tables, one header line
    each, from a case-2 run."""
    _, probes = read_csv(run_dir / "temperature_probes.csv")
    _, mass = read_csv(run_dir / "mass_metrics.csv")
    energy = probes.copy()
    energy[:, 1:] *= 1.02
    am = np.column_stack([mass[:, 0], 0.9 * mass[:, 1], mass[:, 2] + 1e-3,
                          mass[:, 3], mass[:, 4], 1.1 * mass[:, 5]])
    for name, a in (("energy", energy), ("mass", am)):
        np.savetxt(tmp_path / f"am_{case}_{name}", a, header="t values",
                   comments="")
    return tmp_path / f"am_{case}_energy", tmp_path / f"am_{case}_mass"


@pytest.mark.parametrize("case", ["2.1", "2.2"])
def test_compare_case2_matches_jax(runs, tmp_path, case):
    J, P = pkgs("compare_case2")
    src = runs / ("c21" if case == "2.1" else "c22")
    fe, fm = _amaryllis_tables(src, tmp_path, case)
    dj, dp = _both_dirs(src, tmp_path)
    kw = {"case": case, "make_plots": True}
    if case == "2.2":
        pp = tmp_path / "pato_p"
        _, pr = read_csv(src / "pressure_probes.csv")
        pp.write_text("// time probe0(0.001,0.05,0) probe1(0.001,0.049,0)\n"
                      + "".join(f"{r[0]:.6g} {r[1]:.9g} {r[2]:.9g}\n"
                                for r in pr))
        kw["pato_pressure_plot"] = pp
    rj = J.compare(dj, runs / "input.yaml", fe, fm, **kw)
    rp = P.compare(dp, runs / "input.yaml", fe, fm, **kw)
    assert _strip_paths(rp) == _strip_paths(rj)
    name = "amaryllis_error_metrics.csv"
    assert (dp / name).read_text() == (dj / name).read_text()
    pngs = sorted(p.name for p in dp.glob("*.png"))
    assert pngs == sorted(p.name for p in dj.glob("*.png")) and pngs
    if case == "2.2":
        assert any("pressure" in p for p in pngs)


def test_compare_qstar_matches_jax(runs, tmp_path, capsys):
    J, P = pkgs("compare_qstar")
    dj, dp = _both_dirs(runs / "q", tmp_path)
    rj = J.check(dj)
    out_j = capsys.readouterr().out
    rp = P.check(dp)
    assert rp == rj and rp["overall_pass"]
    assert capsys.readouterr().out == out_j
    assert P.main(["--output-dir", str(dp)]) == J.main(
        ["--output-dir", str(dj)]) == 0


PATO_CONSTANTS = """\
R R [0 2 -2 -1 0 0 0] 8.314471469;
K_v K_v [0 2 0 0 0 0 0] (1.6e-11 0 0);
K_c K_c [0 2 0 0 0 0 0] (2.0e-11 0 0);
eps_g_v eps_g_v [0 0 0 0 0 0 0] 0.8;
eps_g_c eps_g_c [0 0 0 0 0 0 0] 0.85;
rhoI[1] rhoI[1] [1 -3 0 0 0 0 0] 1200;
rhoI[2] rhoI[2] [1 -3 0 0 0 0 0] 1600;
epsI[1] epsI[1] [0 0 0 0 0 0 0] 0.1;
epsI[2] epsI[2] [0 0 0 0 0 0 0] 0.1;
// reactions
F[2][1] F[2][1] [0 0 0 0 0 0 0] 0.25;
A[2][1] A[2][1] [0 0 -1 0 0 0 0] 1.2e4;
E[2][1] E[2][1] [1 2 -2 0 -1 0 0] 7.1e4;
m[2][1] m[2][1] [0 0 0 0 0 0 0] 0;
n[2][1] n[2][1] [0 0 0 0 0 0 0] 3;
T[2][1] T[2][1] [0 0 0 1 0 0 0] 333;
h[2][1] h[2][1] [0 2 -2 0 0 0 0] 0;
F[2][2] F[2][2] [0 0 0 0 0 0 0] 0.75;
A[2][2] A[2][2] [0 0 -1 0 0 0 0] 4.48e9;
E[2][2] E[2][2] [1 2 -2 0 -1 0 0] 1.7e5;
m[2][2] m[2][2] [0 0 0 0 0 0 0] 0;
n[2][2] n[2][2] [0 0 0 0 0 0 0] 3;
T[2][2] T[2][2] [0 0 0 1 0 0 0] 555;
h[2][2] h[2][2] [0 2 -2 0 0 0 0] 0;
"""


def _pato_deck(d):
    """A small synthetic PATO TACOT folder (two pressures, three
    temperatures per table)."""
    d.mkdir()
    (d / "constantProperties").write_text(PATO_CONSTANTS)
    rows = lambda cols: "".join(
        f"{p:g} " + " ".join(f"{T * (1 + c / 10):g}" for c in range(cols))
        + "\n" for p in (101325.0, 1013.25) for T in (300.0, 900.0, 1500.0))
    (d / "virgin").write_text("// p T cp h k a b\n" + rows(6))
    (d / "char").write_text(rows(6))
    (d / "gasProperties").write_text(rows(4) + "bad row here\n")
    return d


def test_generate_material_matches_jax(tmp_path):
    J, P = pkgs("generate_material")
    src = _pato_deck(tmp_path / "deck")
    outs = []
    for m, name in ((J, "j.yaml"), (P, "p.yaml")):
        assert m.main(["--source-dir", str(src), "--out",
                       str(tmp_path / name), "--name", "TACOT"]) == 0
        outs.append((tmp_path / name).read_text().replace(str(src), "SRC"))
    assert outs[0] == outs[1] and "reactions:" in outs[1]
    assert P.parse_constant_properties(src / "constantProperties") == \
        J.parse_constant_properties(src / "constantProperties")
    with pytest.raises(RuntimeError, match="Failed to parse R"):
        bad = tmp_path / "bad"
        bad.write_text("nothing\n")
        P.parse_constant_properties(bad)


def test_plotters_match_jax(runs, tmp_path):
    J, P = pkgs("plots")
    newton = runs / "c1" / "newton_history_ablation_case1_2D.csv"
    err = tmp_path / "err.csv"
    err.write_text("step,time,l2_error,linf_error\n"
                   + "".join(f"{i},{0.1 * i},{1e-3 / i},{2e-3 / i}\n"
                             for i in range(1, 6)))
    for m, tag in ((J, "j"), (P, "p")):
        m.plot_l2_vs_time(err, tmp_path / f"{tag}_l2.png")
        m.plot_newton_iterations(newton, tmp_path / f"{tag}_it.png")
        m.plot_newton_solves_per_step(newton, tmp_path / f"{tag}_ps.png")
    for kind in ("l2", "it", "ps"):
        a, b = ((tmp_path / f"{t}_{kind}.png").read_bytes()
                for t in ("j", "p"))
        assert a == b and len(a) > 1000, kind


def test_ale_validation_sweep_and_figures_match_jax(tmp_path):
    """Each package's sweep through its own diffusion_mms_ale on 4 x 4 x 2
    triangles (dt 0.2 and 0.1 to t = 0.2), then the three figures."""
    from cmfem_tpu_torch.core import make_cartesian_mesh_2d, write_gmsh

    J, P = pkgs("plots")
    mesh = write_gmsh(make_cartesian_mesh_2d(4, 4, geom="triangle"),
                      str(tmp_path / "tri.msh"))
    kw = dict(stability_dts=(0.2, 0.1), convergence_dts=(0.2, 0.1),
              t_final=0.2)
    J.ale_validation_sweep(tmp_path / "j", mesh_file=mesh, **kw)
    P.ale_validation_sweep(tmp_path / "p", mesh, device="cpu", **kw)
    for name in ("stability_l2_history.csv", "convergence_errors.csv",
                 "accuracy_errors.csv"):
        a, b = ((tmp_path / t / name).read_text().splitlines()
                for t in ("j", "p"))
        assert a[0] == b[0] and len(a) == len(b) > 2, name
        for ra, rb in zip(a[1:], b[1:]):
            ra, rb = ra.split(","), rb.split(",")
            assert ra[:-1] == rb[:-1], name
            assert float(rb[-1]) == pytest.approx(float(ra[-1]), rel=1e-7)
    written = [P.plot_ale_validation(tmp_path / t, tmp_path / f"fig_{t}")
               for t in ("j", "p")]
    assert [w.name for w in written[0]] == [w.name for w in written[1]]
    assert len(written[1]) == 3
    with pytest.raises(SystemExit):
        P.plot_ale_validation(tmp_path / "empty")
    assert P.main(["ale", str(tmp_path / "p"), "--out",
                   str(tmp_path / "cli")]) == 0
