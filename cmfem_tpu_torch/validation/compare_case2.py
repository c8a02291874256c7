"""Case-2.1 / 2.2 acceptance harnesses: driver CSVs vs Amaryllis references.

Copy of ``cmfem_tpu/validation/compare_case2.py``.

Mirrors compare_ablation_case2_1.py / compare_ablation_case2_2.py:
- temperature matching by probe depth against the Amaryllis energy file
  (col 0 = time, cols 1.. = signals surface-down), with optional segmented
  (heating/cooling window) RMSE for 2.2;
- mass metrics against the Amaryllis mass file
  (cols: time, m_dot_g, [m_dot_c,] front98, front2[, recession]);
- case 2.1 additionally checks m_dot_c ~ 0 and recession ~ 0;
- case 2.2 checks m_dot_c RMSE + peak rel error and recession RMSE +
  final relative error;
writes amaryllis_error_metrics.csv with per-signal PASS bits + overall.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import (
    rmse, max_abs, load_acceptance_from_yaml,
    load_probe_depths_from_yaml, temperature_by_depth_from_probes,
    temperature_by_depth_from_reference, write_metrics_csv, ensure_2d,
    load_pato_point_plot, match_probes_by_y,
)

TOL_21 = {
    "temperature_rmse_max": 250.0, "temperature_max_abs_max": 500.0,
    "m_dot_g_rmse_max": 0.02, "m_dot_g_max_abs_max": 0.06,
    "m_dot_g_peak_rel_error_max": 0.5, "m_dot_g_peak_time_error_max": 10.0,
    "front98_rmse_max": 0.01, "front2_rmse_max": 0.01,
    "m_dot_c_max_abs_max": 1.0e-8, "recession_max_abs_max": 1.0e-8,
}
TOL_22 = {
    "temperature_rmse_max": 300.0, "temperature_max_abs_max": 650.0,
    "m_dot_g_rmse_max": 0.025, "m_dot_g_max_abs_max": 0.08,
    "m_dot_c_rmse_max": 0.01, "m_dot_c_peak_rel_error_max": 0.35,
    "recession_rmse_max": 0.0015, "recession_final_rel_error_max": 0.12,
}


def compare(output_dir, input_yaml, amaryllis_energy, amaryllis_mass,
            case="2.1", make_plots=True, out_prefix=None,
            pato_pressure_plot=None):
    out_dir = Path(output_dir)
    probes = np.genfromtxt(out_dir / "temperature_probes.csv",
                           delimiter=",", names=True)
    mass = np.genfromtxt(out_dir / "mass_metrics.csv",
                         delimiter=",", names=True)
    am_energy = ensure_2d(np.loadtxt(amaryllis_energy, skiprows=1))
    am_mass = ensure_2d(np.loadtxt(amaryllis_mass, skiprows=1))
    tol = load_acceptance_from_yaml(
        input_yaml, TOL_21 if case == "2.1" else TOL_22)
    depths = load_probe_depths_from_yaml(input_yaml)

    mfem_items = temperature_by_depth_from_probes(probes, depths)
    ref_items = temperature_by_depth_from_reference(am_energy, depths)
    n_common = min(len(mfem_items), len(ref_items))
    t_ref = am_energy[:, 0]
    t_mf = probes["time"]

    rows = []
    temp_ok = True
    for (d, nm, sm), (_, nf, sf) in zip(mfem_items[:n_common],
                                        ref_items[:n_common]):
        mi = np.interp(t_ref, t_mf, sm)
        r = rmse(mi, sf)
        m = max_abs(mi, sf)
        ok = (r <= tol["temperature_rmse_max"]
              and m <= tol["temperature_max_abs_max"])
        temp_ok &= ok
        rows.append(["temperature", f"{nm}~{nf}@depth={d:.6g}m", r, m,
                     "", "", "", int(ok)])

    if case == "2.2" and n_common:
        # segmented wall-temperature metrics (heating / cooldown windows,
        # compare_ablation_case2_2.py:384-394,517-519): wall probe = the
        # first (surface-down) pair, valid where the reference is live
        from .common import segmented_rmse_max

        wall_mf = np.interp(t_ref, t_mf, mfem_items[0][2])
        wall_ref = ref_items[0][2]
        valid = wall_ref > 1.0
        for label, t0, t1 in (("wall_heating_0.1_60s", 0.1, 60.0),
                              ("wall_cooling_60.1_120s", 60.1, 120.0)):
            r, m = segmented_rmse_max(t_ref, wall_mf, wall_ref, t0, t1,
                                      valid)
            seg_ok = ((not np.isfinite(r) and not np.isfinite(m))
                      or (r <= tol["temperature_rmse_max"]
                          and m <= tol["temperature_max_abs_max"]))
            temp_ok &= seg_ok
            rows.append(["temperature_segment", label, r, m, "", "", "",
                         int(seg_ok)])

    # mass file columns: time, m_dot_g, m_dot_c, front98, front2[, recession]
    t_am = am_mass[:, 0]
    ref_mdot = am_mass[:, 1]
    t_mass = mass["time"]
    mdot_i = np.interp(t_am, t_mass, mass["m_dot_g_surf"])
    mg_rmse = rmse(mdot_i, ref_mdot)
    mg_max = max_abs(mdot_i, ref_mdot)
    mg_ok = (mg_rmse <= tol["m_dot_g_rmse_max"]
             and mg_max <= tol["m_dot_g_max_abs_max"])
    rows.append(["mass_flux", "m_dot_g", mg_rmse, mg_max, "",
                 "", tol["m_dot_g_rmse_max"], int(mg_ok)])
    checks = [temp_ok, mg_ok]

    if case == "2.1":
        mc_max = float(np.abs(mass["m_dot_c"]).max())
        rec_max = float(np.abs(mass["recession"]).max())
        mc_ok = mc_max <= tol["m_dot_c_max_abs_max"]
        rec_ok = rec_max <= tol["recession_max_abs_max"]
        rows.append(["mass_flux", "m_dot_c", "", mc_max, "max_abs", mc_max,
                     tol["m_dot_c_max_abs_max"], int(mc_ok)])
        rows.append(["recession", "recession", "", rec_max, "max_abs",
                     rec_max, tol["recession_max_abs_max"], int(rec_ok)])
        checks += [mc_ok, rec_ok]
    else:
        ref_mc = am_mass[:, 2]
        ref_rec = am_mass[:, 5] if am_mass.shape[1] > 5 else np.zeros_like(t_am)
        mc_i = np.interp(t_am, t_mass, mass["m_dot_c"])
        rec_i = np.interp(t_am, t_mass, mass["recession"])
        mc_rmse = rmse(mc_i, ref_mc)
        i_mf = int(np.argmax(mass["m_dot_c"]))
        i_am = int(np.argmax(ref_mc))
        mc_peak_rel = abs(float(mass["m_dot_c"][i_mf]) - float(ref_mc[i_am])) \
            / max(abs(float(ref_mc[i_am])), 1e-12)
        rec_rmse = rmse(rec_i, ref_rec)
        rec_final_rel = abs(float(mass["recession"][-1]) - float(ref_rec[-1])) \
            / max(abs(float(ref_rec[-1])), 1e-12)
        mc_ok = (mc_rmse <= tol["m_dot_c_rmse_max"]
                 and mc_peak_rel <= tol["m_dot_c_peak_rel_error_max"])
        rec_ok = (rec_rmse <= tol["recession_rmse_max"]
                  and rec_final_rel <= tol["recession_final_rel_error_max"])
        rows.append(["mass_flux", "m_dot_c", mc_rmse, "", "peak_rel_error",
                     mc_peak_rel, tol["m_dot_c_peak_rel_error_max"],
                     int(mc_ok)])
        rows.append(["recession", "recession", rec_rmse, "",
                     "final_rel_error", rec_final_rel,
                     tol["recession_final_rel_error_max"], int(rec_ok)])
        checks += [mc_ok, rec_ok]

    overall = all(checks)
    rows.append(["summary", "overall", "", "", "", "", "", int(overall)])
    out_csv = out_dir / "amaryllis_error_metrics.csv"
    write_metrics_csv(out_csv, rows)

    if make_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        prefix = out_prefix or f"ablation_case{case.replace('.', '_')}"
        plt.figure(figsize=(9, 4.8))
        plt.plot(t_mass, mass["m_dot_g_surf"], "k-", lw=2, label="cmfem m_dot_g")
        plt.plot(t_am, ref_mdot, "k--", lw=2, label="Amaryllis m_dot_g")
        if case == "2.2":
            plt.plot(t_mass, mass["m_dot_c"], "r-", lw=2, label="cmfem m_dot_c")
            plt.plot(t_am, am_mass[:, 2], "r--", lw=2, label="Amaryllis m_dot_c")
        plt.xlabel("Time (s)")
        plt.ylabel("Mass flux (kg/m2/s)")
        plt.grid(True, alpha=0.25)
        plt.legend()
        plt.tight_layout()
        plt.savefig(out_dir / f"{prefix}_mass_flux.png", dpi=180)
        plt.close()

        # pressure-probe overlay vs a PATO sampled point plot (2.2 only;
        # plots-only in the reference too, compare_ablation_case2_2.py:1150+)
        if case == "2.2" and pato_pressure_plot is not None:
            from .common import _safe_load_yaml

            pp = np.genfromtxt(out_dir / "pressure_probes.csv",
                               delimiter=",", names=True)
            raw_y = _safe_load_yaml(input_yaml).get("probe_y", [])
            probe_y = []
            for v in raw_y:
                try:
                    probe_y.append(float(v))
                except (TypeError, ValueError):
                    pass
            t_pa, vals_pa, y_pa = load_pato_point_plot(pato_pressure_plot)
            names = [n for n in (pp.dtype.names or []) if n != "time"]
            matched = match_probes_by_y(
                names, {n: pp[n] for n in names}, probe_y, y_pa)
            if matched:
                plt.figure(figsize=(9, 4.8))
                for k, (yp, nm, j, series) in enumerate(matched[:4]):
                    c = f"C{k}"
                    plt.plot(pp["time"], series, c + "-", lw=2,
                             label=f"cmfem {nm} (y={yp:g})")
                    plt.plot(t_pa, vals_pa[:, j], c + "--", lw=2,
                             label=f"PATO (y={yp:g})")
                plt.xlabel("Time (s)")
                plt.ylabel("Pressure (Pa)")
                plt.grid(True, alpha=0.25)
                plt.legend(fontsize=8)
                plt.tight_layout()
                plt.savefig(out_dir / f"{prefix}_pressure_probes.png",
                            dpi=180)
                plt.close()

    print(f"Wrote: {out_csv}")
    print(f"Overall PASS: {overall}")
    return {"overall_pass": overall, "metrics_csv": str(out_csv)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", choices=["2.1", "2.2"], default="2.1")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--input", default=None)
    ap.add_argument("--amaryllis-energy", required=True)
    ap.add_argument("--amaryllis-mass", required=True)
    ap.add_argument("--pato-pressure-plot", default=None,
                    help="PATO sampled point plot for pressure (2.2 only)")
    args = ap.parse_args(argv)
    out_dir = args.output_dir or f"ParaView/ablation_case{args.case.replace('.', '_')}"
    inp = args.input or f"Input/input_ablation_case{args.case.replace('.', '_')}.yaml"
    compare(out_dir, inp, args.amaryllis_energy, args.amaryllis_mass,
            case=args.case, pato_pressure_plot=args.pato_pressure_plot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
