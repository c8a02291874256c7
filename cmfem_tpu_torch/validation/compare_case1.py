"""Case-1 acceptance harness: driver CSVs vs FIAT reference histories.

Copy of ``cmfem_tpu/validation/compare_case1.py``; mirrors the reference's
compare_ablation_case1.py (the FIAT files are arguments):
interpolates driver probe/mass signals to the FIAT times, computes per-probe
temperature RMSE/max-abs, pyrolysis mass-flux peak magnitude/time errors,
and 98%-virgin / 2%-char front RMSEs against tolerances from the driver
input YAML; writes fiat_error_metrics.csv (per-signal PASS bits + overall)
and three comparison PNGs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import (
    rmse, max_abs, load_acceptance_from_yaml, load_probe_depths_from_yaml,
    temperature_by_depth_from_probes, temperature_by_depth_from_reference,
    write_metrics_csv,
)

DEFAULT_TOL = {
    "temperature_rmse_max": 150.0,
    "temperature_max_abs_max": 300.0,
    "m_dot_g_peak_rel_error_max": 0.5,
    "m_dot_g_peak_time_error_max": 10.0,
    "front98_rmse_max": 0.01,
    "front2_rmse_max": 0.01,
}


def compare(output_dir, input_yaml, fiat_T_file, fiat_front_file,
            out_prefix="ablation_case1", make_plots=True):
    out_dir = Path(output_dir)
    probes = np.genfromtxt(out_dir / "temperature_probes.csv",
                           delimiter=",", names=True)
    mass = np.genfromtxt(out_dir / "mass_metrics.csv",
                         delimiter=",", names=True)
    fiat_T = np.loadtxt(fiat_T_file)
    fiat_front = np.loadtxt(fiat_front_file)
    tol = load_acceptance_from_yaml(input_yaml, DEFAULT_TOL)
    depths = load_probe_depths_from_yaml(input_yaml)

    mfem_items = temperature_by_depth_from_probes(probes, depths)
    ref_items = temperature_by_depth_from_reference(fiat_T, depths)
    n_common = min(len(mfem_items), len(ref_items))
    t_ref = fiat_T[:, 0]
    t_mf = probes["time"]

    rows = []
    temp_ok = True
    pairs = list(zip(mfem_items[:n_common], ref_items[:n_common]))
    for (d, name_mf, sig_mf), (_, name_fi, sig_fi) in pairs:
        mi = np.interp(t_ref, t_mf, sig_mf)
        r = rmse(mi, sig_fi)
        m = max_abs(mi, sig_fi)
        ok = (r <= tol["temperature_rmse_max"]
              and m <= tol["temperature_max_abs_max"])
        temp_ok &= ok
        rows.append(["temperature", f"{name_mf}~{name_fi}@depth={d:.6g}m",
                     r, m, "", "", "", int(ok)])

    # FIAT pyrolysisFront columns: 2 = mass flux, 7 = 2% char, 8 = 98% virgin
    t_front = fiat_front[:, 0]
    ref_mdot = fiat_front[:, 2]
    ref_front2 = fiat_front[:, 7]
    ref_front98 = fiat_front[:, 8]
    t_mass = mass["time"]
    mdot = mass["m_dot_g_surf"]
    f98 = mass["front_98_virgin"]
    f2 = mass["front_2_char"]

    mdot_i = np.interp(t_front, t_mass, mdot)
    mdot_rmse = rmse(mdot_i, ref_mdot)
    mdot_max = max_abs(mdot_i, ref_mdot)
    i_mf = int(np.argmax(mdot))
    i_fi = int(np.argmax(ref_mdot))
    peak_rel = abs(float(mdot[i_mf]) - float(ref_mdot[i_fi])) / \
        max(abs(float(ref_mdot[i_fi])), 1e-12)
    peak_time = abs(float(t_mass[i_mf]) - float(t_front[i_fi]))
    f98_rmse = rmse(np.interp(t_front, t_mass, f98), ref_front98)
    f98_max = max_abs(np.interp(t_front, t_mass, f98), ref_front98)
    f2_rmse = rmse(np.interp(t_front, t_mass, f2), ref_front2)
    f2_max = max_abs(np.interp(t_front, t_mass, f2), ref_front2)

    peak_rel_ok = peak_rel <= tol["m_dot_g_peak_rel_error_max"]
    peak_time_ok = peak_time <= tol["m_dot_g_peak_time_error_max"]
    f98_ok = f98_rmse <= tol["front98_rmse_max"]
    f2_ok = f2_rmse <= tol["front2_rmse_max"]
    overall = temp_ok and peak_rel_ok and peak_time_ok and f98_ok and f2_ok

    rows += [
        ["mass_flux", "m_dot_g", mdot_rmse, mdot_max, "peak_rel_error",
         peak_rel, tol["m_dot_g_peak_rel_error_max"], int(peak_rel_ok)],
        ["mass_flux", "m_dot_g", "", "", "peak_time_error", peak_time,
         tol["m_dot_g_peak_time_error_max"], int(peak_time_ok)],
        ["front", "front_98_virgin", f98_rmse, f98_max, "", "",
         tol["front98_rmse_max"], int(f98_ok)],
        ["front", "front_2_char", f2_rmse, f2_max, "", "",
         tol["front2_rmse_max"], int(f2_ok)],
        ["summary", "overall", "", "", "", "", "", int(overall)],
    ]
    out_csv = out_dir / "fiat_error_metrics.csv"
    write_metrics_csv(out_csv, rows)

    if make_plots:
        _plots(out_dir, out_prefix, pairs, t_mf, t_ref, t_mass, t_front,
               mdot, ref_mdot, f98, f2, ref_front98, ref_front2)

    print(f"Wrote: {out_csv}")
    print(f"Overall PASS: {overall}")
    return {"overall_pass": overall, "temperature_pass": temp_ok,
            "mdot_peak_pass": peak_rel_ok and peak_time_ok,
            "front98_pass": f98_ok, "front2_pass": f2_ok,
            "metrics_csv": str(out_csv)}


def _plots(out_dir, prefix, pairs, t_mf, t_ref, t_mass, t_front, mdot,
           ref_mdot, f98, f2, ref_front98, ref_front2):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 5))
    cmap = plt.get_cmap("tab10")
    for i, ((d, nm, sm), (_, nf, sf)) in enumerate(pairs):
        col = "black" if i == 0 else cmap((i - 1) % 10)
        plt.plot(t_mf, sm, color=col, lw=2, label=f"cmfem {nm} ({d:.4f} m)")
        plt.plot(t_ref, sf, color=col, lw=1.6, ls="--",
                 label=f"FIAT {nf} ({d:.4f} m)")
    plt.xlabel("Time (s)")
    plt.ylabel("Temperature (K)")
    plt.grid(True, alpha=0.25)
    plt.legend(ncol=3, fontsize=8)
    plt.tight_layout()
    plt.savefig(out_dir / f"{prefix}_temperature_history.png", dpi=180)
    plt.close()

    plt.figure(figsize=(9, 4.8))
    plt.plot(t_mass, mdot, "k-", lw=2, label="cmfem")
    plt.plot(t_front, ref_mdot, "k--", lw=2, label="FIAT")
    plt.xlabel("Time (s)")
    plt.ylabel("Pyrolysis mass flux (kg/m2/s)")
    plt.grid(True, alpha=0.25)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_dir / f"{prefix}_pyrolysis_mass_flux.png", dpi=180)
    plt.close()

    plt.figure(figsize=(9, 4.8))
    plt.plot(t_mass, f98, "k-", lw=2, label="cmfem 98% virgin")
    plt.plot(t_mass, f2, "-", color="gray", lw=2, label="cmfem 2% char")
    plt.plot(t_front, ref_front98, "k--", lw=2, label="FIAT 98% virgin")
    plt.plot(t_front, ref_front2, "--", color="gray", lw=2, label="FIAT 2% char")
    plt.xlabel("Time (s)")
    plt.ylabel("Depth (m)")
    plt.grid(True, alpha=0.25)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_dir / f"{prefix}_fronts.png", dpi=180)
    plt.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--output-dir", default="ParaView/ablation_case1")
    ap.add_argument("--input", default="Input/input_ablation_case1.yaml")
    ap.add_argument("--fiat-T", required=False,
                    default="data/ref/FIAT/T")
    ap.add_argument("--fiat-front", required=False,
                    default="data/ref/FIAT/pyrolysisFront")
    ap.add_argument("--out-prefix", default="ablation_case1")
    args = ap.parse_args(argv)
    compare(args.output_dir, args.input, args.fiat_T, args.fiat_front,
            args.out_prefix)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
