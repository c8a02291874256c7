"""Full-horizon runner of the three ablation cases.

Port of the JAX package's ``scripts/fullrun.py``.  Runs one case end to end
through the port's driver and writes an artifact JSON (wall-clock, per-step
Newton statistics, temperature bounds, pyrolysis-front motion, recession
(2.2), minimum mesh quality (2.2) and the ``sane`` predicate):

  case1   : apps.ablation_case1    dt 0.1,    t_final  60 s ->    600 steps
  case2_1 : apps.ablation_case2_1  dt 0.1,    t_final 120 s ->  1,200 steps
  case2_2 : apps.ablation_case2_2  dt 0.0025, t_final 120 s -> 48,000 steps

(the reference decks' dt and t_final).  The decks are synthetic, built by
``deck``: the graded strip ``core.make_strip_mesh_2d(11, 239)`` (triangles
for 2.2, as chip_smoke phase 13), the TACOT deck
``tests/fixtures/tacot_synthetic.json`` for the reference's
material_tacot_case*.yaml, ``BPrimeTable.synthetic_tacot()`` for its B'
table and, for 2.1 and 2.2, the schedule ``tests/fixtures/
surface_bc_case21.dat`` for its surface BC file; case 1 takes the driver's
default wall-temperature schedule (300 -> 1644 K at 0.1 s, back to 300 K
at 60.1 s).  The synthetic surface schedule ends at t = 2.0 s
(``schedule_end_s`` in the artifact) with chemistry off from 0.41 s, so it
has no 60.1 s chemistry switch; past its last row the drivers hold that
row (convective cooling).  The 2.x horizons of the reference decks wait
for the reference schedule: no schedule rows are made up here.

The ablation port runs in float64 only (the drivers refuse float32), so
there is no ``--x64``; ``--cpu`` runs on the CPU, the default is the card.

    python -m cmfem_tpu_torch.scripts.fullrun case1 [--t-final X]
        [--eager] [--output-every N] [--out-dir DIR] [--artifact PATH]
        [--cpu] [--summarize-only --wall-s S]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import platform as _platform
import sys
import time

from . import common

DECKS = {
    "case1": ("ablation_case1", 0.1, 60.0),
    "case2_1": ("ablation_case2_1", 0.1, 120.0),
    "case2_2": ("ablation_case2_2", 0.0025, 120.0),
}
NEWTON_CSV = {
    "case1": "newton_history_ablation_case1_2D.csv",
    "case2_1": "newton_history_ablation_case2_1_2D.csv",
    "case2_2": "newton_history_ablation_case2_2_2D.csv",
}
# the last row's time of tests/fixtures/surface_bc_case21.dat
SCHEDULE_END_S = 2.0


def deck(case, out_dir, nx=11, ny=239):
    """The synthetic deck of ``case`` (a driver config) with its strip mesh
    written into ``out_dir`` and its outputs going there."""
    _, dt, t_final = DECKS[case]
    geom = "triangle" if case == "case2_2" else "quad"
    cfg = {"mesh_file": common.strip_file(out_dir, nx, ny, geom),
           "material_file": common.TACOT_DECK, "order": 1, "dt": dt,
           "t_final": t_final, "bdr_attr_top": common.STRIP_TOP,
           "probe_x": 0.00125, "newton_csv": NEWTON_CSV[case]}
    if case != "case1":
        cfg["boundary_conditions_file"] = common.SCHEDULE
    if case == "case2_2":
        cfg["bdr_attr_bottom"] = common.STRIP_BOTTOM
    return cfg


def _col(rows, header, name):
    return [float(r[header.index(name)]) for r in rows]


def _read_csv(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    return header, rows


def summarize(case, out_dir, cfg, wall_s, run_out, platform, extra):
    """The artifact of a run from the CSVs in ``out_dir`` (as JAX's)."""
    art = {
        "case": case,
        "deck": f"synthetic ({cfg.get('mesh_file')}, "
                f"{cfg.get('material_file')})",
        "platform": platform,
        "hostname": _platform.node(),
        "dt": cfg["dt"],
        "t_final": cfg["t_final"],
        "wall_s": None if wall_s is None else round(wall_s, 2),
        **extra,
    }

    # Newton history: iterations per step + convergence
    nh_name = cfg.get("newton_csv", "newton_history.csv")
    nh = os.path.join(out_dir, nh_name)
    if os.path.isfile(nh):
        header, rows = _read_csv(nh)
        steps = {}
        for r in rows:
            s = int(float(r[header.index("step")]))
            it = int(float(r[header.index("iter")]))
            steps[s] = max(steps.get(s, 0), it + 1)
        iters = list(steps.values())
        art["n_steps"] = len(steps)
        art["newton_iters_mean"] = round(sum(iters) / max(1, len(iters)), 3)
        art["newton_iters_max"] = max(iters) if iters else 0
    art["ms_per_step"] = None if wall_s is None else round(
        1e3 * wall_s / max(1, art.get("n_steps", 1)), 2)

    # mass metrics: fronts, mdot peak, recession
    mm = os.path.join(out_dir, cfg.get("mass_csv", "mass_metrics.csv"))
    if os.path.isfile(mm):
        header, rows = _read_csv(mm)
        t = _col(rows, header, "time")
        mdot = _col(rows, header, "m_dot_g_surf")
        imax = max(range(len(mdot)), key=lambda i: mdot[i])
        art["mdot_g_peak"] = round(mdot[imax], 6)
        art["mdot_g_peak_time"] = t[imax]
        for key in ("front_98_virgin", "front_2_char"):
            if key in header:
                v = _col(rows, header, key)
                fin = [x for x in v if x == x]  # drop NaN
                art[f"{key}_final"] = round(fin[-1], 6) if fin else None
        if "recession" in header:
            rec = _col(rows, header, "recession")
            art["recession_final_m"] = rec[-1]
            art["recession_monotone"] = all(
                b >= a - 1e-12 for a, b in zip(rec, rec[1:]))

    # temperature probes: bounds over the whole run
    pr = os.path.join(out_dir, cfg.get("probes_csv",
                                       "temperature_probes.csv"))
    if os.path.isfile(pr):
        header, rows = _read_csv(pr)
        vals = [float(v) for r in rows for v in r[1:]
                if v not in ("", "nan") and float(v) == float(v)]
        art["T_min"] = round(min(vals), 2)
        art["T_max"] = round(max(vals), 2)

    # mesh quality (2.2)
    md = os.path.join(out_dir, cfg.get("meshdiag_csv",
                                       "mesh_diagnostics.csv"))
    if os.path.isfile(md):
        header, rows = _read_csv(md)
        if "min_quality_ratio" in header:
            q = _col(rows, header, "min_quality_ratio")
            art["min_quality_ratio"] = round(min(q), 4)

    art["sane"] = bool(
        art.get("n_steps", 0) > 0
        and art.get("T_max", 0) > 320.0
        and art.get("T_min", 0) >= 250.0
        and art.get("T_max", 1e9) < 4000.0
        and art.get("recession_monotone", True)
        and art.get("min_quality_ratio", 1.0) > 0.05)
    return art


def parse_args(argv=None):
    ap = common.add_run_args(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("case", choices=sorted(DECKS))
    ap.add_argument("--t-final", type=float, default=None,
                    help="override the horizon")
    ap.add_argument("--output-every", type=int, default=200,
                    help="scan_stepping frame length (steps per read-back)")
    ap.add_argument("--eager", action="store_true",
                    help="the host-stepped loop (host LU) instead of "
                         "scan_stepping")
    ap.add_argument("--newton-rel-tol", type=float, default=None)
    ap.add_argument("--newton-abs-tol", type=float, default=None)
    ap.add_argument("--gmres-maxiter", type=int, default=None)
    ap.add_argument("--gmres-restart", type=int, default=None)
    ap.add_argument("--linear-rtol", type=float, default=None,
                    help="GMRES relative tolerance (driver default 1e-10)")
    ap.add_argument("--stall-improve", type=float, default=0.01,
                    help="newton_stall_improve of the Newton loops: an "
                         "iteration counts as progress only if it improves "
                         "the residual by this fraction")
    ap.add_argument("--artifact", default=None,
                    help="the artifact's path (default: "
                         "<out-dir>/fullrun_<case>.json)")
    ap.add_argument("--summarize-only", action="store_true",
                    help="skip the run; rebuild the artifact from the CSVs "
                         "already in --out-dir (flushed per row, so a run "
                         "cut short still yields a partial artifact)")
    ap.add_argument("--wall-s", type=float, default=None,
                    help="wall-clock to record with --summarize-only "
                         "(omitted: wall_s and ms_per_step are null)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_dir = common.out_dir(args.out_dir, f"fullrun_{args.case}")
    cfg = deck(args.case, out_dir)
    cfg.update(output_path=out_dir, save_paraview=False,
               scan_stepping=not args.eager,
               output_every=args.output_every, newton_print_level=0)
    if args.t_final is not None:
        cfg["t_final"] = args.t_final
    for key in ("newton_rel_tol", "newton_abs_tol", "gmres_maxiter",
                "gmres_restart", "linear_rtol"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    if args.stall_improve is not None:
        cfg["newton_stall_improve"] = args.stall_improve

    extra = {"scan_stepping": not args.eager, "dtype": "float64"}
    if args.case != "case1":
        extra["schedule_end_s"] = SCHEDULE_END_S
    overrides = {k: getattr(args, k) for k in
                 ("newton_rel_tol", "newton_abs_tol", "gmres_maxiter",
                  "gmres_restart", "linear_rtol", "stall_improve",
                  "output_every") if getattr(args, k) is not None}
    if overrides:
        extra["overrides"] = overrides
    if args.summarize_only:
        # reads CSVs only: never asks for the card, which another run may
        # hold
        platform, wall, run_out = "none", args.wall_s, {}
        extra["partial"] = True
    else:
        device = common.run_device(args.cpu)
        platform = device.type
        extra["card"] = common.card(device)
        mod = importlib.import_module(
            f"cmfem_tpu_torch.apps.{DECKS[args.case][0]}")
        print(f"fullrun {args.case}: device={device} dt={cfg['dt']} "
              f"t_final={cfg['t_final']} scan={not args.eager}", flush=True)
        t0 = time.perf_counter()
        run_out = mod.run(cfg, device=device)
        common.sync(device)
        wall = time.perf_counter() - t0
        if args.case == "case2_2":
            extra["recession_total_m"] = float(
                run_out.get("recession_total", 0.0))
        if run_out.get("newton_stall_stats"):
            extra["newton_stall_stats"] = run_out["newton_stall_stats"]
    art = summarize(args.case, out_dir, cfg, wall, run_out, platform, extra)
    path = args.artifact or os.path.join(out_dir,
                                         f"fullrun_{args.case}.json")
    common.write_json(path, art)
    print(json.dumps(art))
    print(f"wrote {path}")
    return 0 if art["sane"] else 1


if __name__ == "__main__":
    sys.exit(main())
