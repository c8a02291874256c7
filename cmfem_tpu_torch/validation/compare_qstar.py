"""Q* blowing 1D verifier checks + plot.

Copy of ``cmfem_tpu/validation/compare_qstar.py``.

Port of compare_ablation_qstar_blowing_1D.py: validates the profile and
summary CSVs of the Q* driver (profile matches the analytic exponential to
tolerance; sdot relative error within bound) and plots numeric vs analytic."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def check(output_dir, sdot_rel_tol=5e-3, profile_linf_tol=5.0,
          make_plots=True):
    out_dir = Path(output_dir)
    prof = np.genfromtxt(out_dir / "qstar_blowing_profile.csv",
                         delimiter=",", names=True)
    summ = np.genfromtxt(out_dir / "qstar_blowing_summary.csv",
                         delimiter=",", names=True)
    summ = np.atleast_1d(summ)
    sdot_rel = float(np.abs(summ["sdot_rel_error"][-1]))
    linf = float(np.abs(prof["T_numeric_K"] - prof["T_exact_table_K"]).max())
    sdot_ok = sdot_rel <= sdot_rel_tol
    prof_ok = linf <= profile_linf_tol
    overall = sdot_ok and prof_ok

    if make_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 4.5))
        plt.plot(prof["x_m"], prof["T_numeric_K"], "k-", lw=2, label="numeric")
        plt.plot(prof["x_m"], prof["T_exact_table_K"], "r--", lw=2,
                 label="analytic (Table 4 sdot)")
        plt.plot(prof["x_m"], prof["T_exact_numerical_s_K"], "b:", lw=2,
                 label="analytic (numeric sdot)")
        plt.xlabel("x (m)")
        plt.ylabel("T (K)")
        plt.grid(True, alpha=0.25)
        plt.legend()
        plt.tight_layout()
        plt.savefig(out_dir / "qstar_blowing_profile.png", dpi=180)
        plt.close()

    print(f"sdot rel error: {sdot_rel:.3e} (tol {sdot_rel_tol}) "
          f"{'PASS' if sdot_ok else 'FAIL'}")
    print(f"profile Linf: {linf:.3e} K (tol {profile_linf_tol}) "
          f"{'PASS' if prof_ok else 'FAIL'}")
    print(f"Overall PASS: {overall}")
    return {"overall_pass": overall, "sdot_rel_error": sdot_rel,
            "profile_linf": linf}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--output-dir", default="ParaView/qstar_ablation_blowing_1D")
    ap.add_argument("--sdot-rel-tol", type=float, default=5e-3)
    ap.add_argument("--profile-linf-tol", type=float, default=5.0)
    args = ap.parse_args(argv)
    out = check(args.output_dir, args.sdot_rel_tol, args.profile_linf_tol)
    return 0 if out["overall_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
