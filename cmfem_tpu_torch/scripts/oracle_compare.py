"""Drift of one full-horizon run against another of the same deck.

Port of the JAX package's ``scripts/oracle_compare.py`` (numpy only).  The
reference validates against FIAT/Amaryllis histories that this repo does
not hold, so the end-to-end anchor is the port against itself: a
``fullrun`` output directory from the card against one from the CPU
(``fullrun <case> --cpu``), both float64.  Their agreement bounds what the
card's arithmetic (other summation orders, fused multiply-adds, atomics)
adds to the whole pipeline over many steps: tables, reaction Newton,
linear solves, SEB, recession, remap.

The result keeps the JAX package's keys: ``oracle_dir`` and ``f64`` name
the reference run (the CPU's), ``f32_dir`` and ``f32`` the run under test
(here the card's float64 run, where the JAX package compared its float32
chip run).  Only the overlapping time range is compared, so the CPU run
may stop earlier than the card's.

    python -m cmfem_tpu_torch.scripts.oracle_compare case1
        --oracle-dir CPU_OUT --run-dir CARD_OUT [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def read_csv(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(",")
    rows = np.array([[float(v) if v not in ("", "nan") else np.nan
                      for v in ln.split(",")] for ln in lines[1:]])
    return header, rows


def col(header, rows, name):
    return rows[:, header.index(name)]


def interp_to(t_ref, t, v):
    """Interpolate v(t) onto t_ref; NaNs propagate through holes."""
    good = np.isfinite(v)
    if good.sum() < 2:
        return np.full_like(t_ref, np.nan)
    out = np.interp(t_ref, t[good], v[good])
    # re-mask times that fall inside NaN holes of the source
    holes = np.interp(t_ref, t, np.where(good, 0.0, 1.0))
    return np.where(holes > 0.5, np.nan, out)


def signal_drift(t_o, v_o, t_f, v_f):
    """RMSE / max-abs of the run's signal against the reference run's over
    the overlapping time range (the run interpolated onto the reference's
    times)."""
    vf = interp_to(t_o, t_f, v_f)
    m = np.isfinite(v_o) & np.isfinite(vf)
    if not m.any():
        return {"n": 0}
    d = vf[m] - v_o[m]
    rng = float(np.nanmax(v_o) - np.nanmin(v_o))
    return {
        "n": int(m.sum()),
        "rmse": float(np.sqrt(np.mean(d * d))),
        "max_abs": float(np.max(np.abs(d))),
        "rel_rmse_of_range": float(np.sqrt(np.mean(d * d))
                                   / max(rng, 1e-300)),
        "range": rng,
    }


def compare_case(case, oracle_dir, f32_dir):
    """Probe, mass-metric and (2.2) pressure-probe drift of the run in
    ``f32_dir`` against the reference run in ``oracle_dir``."""
    out = {"case": case, "oracle_dir": oracle_dir, "f32_dir": f32_dir,
           "note": "t=0 rows excluded: they are initial-condition "
                   "bookkeeping (the scan path historically wrote "
                   "computed step-0 diagnostics, the oracle writes "
                   "zeros), not simulation drift"}

    def read_csv_(path):
        h, r = read_csv(path)
        return h, r[r[:, h.index("time")] > 0.0]

    # temperature probes: every TC column
    ho, ro = read_csv_(os.path.join(oracle_dir, "temperature_probes.csv"))
    hf, rf = read_csv_(os.path.join(f32_dir, "temperature_probes.csv"))
    t_o, t_f = col(ho, ro, "time"), col(hf, rf, "time")
    out["t_overlap"] = [float(t_o[0]), float(min(t_o[-1], t_f[-1]))]
    probes = {}
    for name in ho[1:]:
        if name in hf:
            probes[name] = signal_drift(t_o, col(ho, ro, name),
                                        t_f, col(hf, rf, name))
    out["temperature_probes"] = probes
    out["probe_rel_rmse_max"] = max(
        (v["rel_rmse_of_range"] for v in probes.values() if v.get("n")),
        default=None)

    # mass metrics: mdot_g, fronts, recession
    ho, ro = read_csv_(os.path.join(oracle_dir, "mass_metrics.csv"))
    hf, rf = read_csv_(os.path.join(f32_dir, "mass_metrics.csv"))
    t_o, t_f = col(ho, ro, "time"), col(hf, rf, "time")
    mass = {}
    for name in ("m_dot_g_surf", "front_98_virgin", "front_2_char",
                 "recession"):
        if name in ho and name in hf:
            mass[name] = signal_drift(t_o, col(ho, ro, name),
                                      t_f, col(hf, rf, name))
    out["mass_metrics"] = mass
    if "recession" in mass and mass["recession"].get("n"):
        tend = min(t_o[-1], t_f[-1])
        r_o = interp_to(np.asarray([tend]), t_o, col(ho, ro, "recession"))
        r_f = interp_to(np.asarray([tend]), t_f, col(hf, rf, "recession"))
        out["recession_at_overlap_end"] = {
            "t": float(tend), "f64": float(r_o[0]), "f32": float(r_f[0]),
            "rel_err": float(abs(r_f[0] - r_o[0])
                             / max(abs(r_o[0]), 1e-300))}

    # pressure probes (2.2 only)
    pp_o = os.path.join(oracle_dir, "pressure_probes.csv")
    pp_f = os.path.join(f32_dir, "pressure_probes.csv")
    if os.path.isfile(pp_o) and os.path.isfile(pp_f):
        ho, ro = read_csv_(pp_o)
        hf, rf = read_csv_(pp_f)
        t_o, t_f = col(ho, ro, "time"), col(hf, rf, "time")
        pr = {}
        for name in ho[1:]:
            if name in hf:
                pr[name] = signal_drift(t_o, col(ho, ro, name),
                                        t_f, col(hf, rf, name))
        out["pressure_probes"] = pr
        out["pressure_rel_rmse_max"] = max(
            (v["rel_rmse_of_range"] for v in pr.values() if v.get("n")),
            default=None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("case", nargs="?", default="case1")
    ap.add_argument("--oracle-dir", required=True,
                    help="the reference run's fullrun output directory")
    ap.add_argument("--run-dir", required=True,
                    help="the compared run's fullrun output directory")
    ap.add_argument("--out-dir", default=None,
                    help="where the result goes (default: a new directory "
                         "under the system's temporary directory)")
    args = ap.parse_args(argv)
    art = compare_case(args.case, args.oracle_dir, args.run_dir)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="cmfem_oracle_")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"oracle_drift_{args.case}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({k: v for k, v in art.items()
                      if not isinstance(v, dict)}))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
