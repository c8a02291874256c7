"""Plotters for the driver CSV outputs.

Ports of plot_l2_vs_time.py, plot_newton_iterations.py,
plot_newton_solves_per_step.py, and plot_ale_validation_be.py — each
consumes driver CSVs and writes PNGs.

The ALE validation figures (plot_ale_validation_be.py:1-341) consume
three CSVs the reference's ale_validation_be drivers would have produced
(their sources are absent from the reference — dead makefile targets,
makefile:55,88-100).  Here `ale_validation_sweep` regenerates the same
data contract from the port's own diffusion_mms_ale driver (copy of
``cmfem_tpu/validation/plots.py``; the mesh is an argument):
  stability_l2_history.csv : dt,time,l2_norm   (per-dt norm histories)
  convergence_errors.csv   : dt,l2_error       (final error vs dt)
  accuracy_errors.csv      : map,dt,l2_error   (fixed vs map_A/map_B)
and the fig7_* plotters render the paper-style stability / convergence /
accuracy figures from them."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_l2_vs_time(error_csv, out_png, log_y=True):
    """L2-error history from any driver error CSV (step,time,...l2...)."""
    plt = _plt()
    data = np.genfromtxt(error_csv, delimiter=",", names=True)
    t = data["time"]
    plt.figure(figsize=(8, 4.5))
    for name in data.dtype.names:
        if "l2" in name.lower():
            plt.plot(t, data[name], lw=2, label=name)
    plt.xlabel("Time (s)")
    plt.ylabel("L2 error")
    if log_y:
        plt.yscale("log")
    plt.grid(True, alpha=0.25)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png, dpi=180)
    plt.close()
    return out_png


def plot_newton_iterations(newton_csv, out_png):
    """Per-solve residual trajectories from a Newton history CSV."""
    plt = _plt()
    data = np.genfromtxt(newton_csv, delimiter=",", names=True)
    plt.figure(figsize=(8, 4.5))
    steps = np.unique(data["step"])
    for s in steps[:: max(1, len(steps) // 20)]:
        sel = data["step"] == s
        plt.semilogy(data["iter"][sel], data["residual"][sel], "-o",
                     ms=3, lw=1, alpha=0.6)
    plt.xlabel("Newton iteration")
    plt.ylabel("|R|")
    plt.grid(True, alpha=0.25)
    plt.tight_layout()
    plt.savefig(out_png, dpi=180)
    plt.close()
    return out_png


def plot_newton_solves_per_step(newton_csv, out_png):
    """Newton iteration count per time step."""
    plt = _plt()
    data = np.genfromtxt(newton_csv, delimiter=",", names=True)
    steps = np.unique(data["step"])
    counts = [int(data["iter"][data["step"] == s].max()) + 1 for s in steps]
    times = [float(data["time"][data["step"] == s][0]) for s in steps]
    plt.figure(figsize=(8, 4.5))
    plt.plot(times, counts, "k-", lw=1.5)
    plt.xlabel("Time (s)")
    plt.ylabel("Newton iterations per step")
    plt.grid(True, alpha=0.25)
    plt.tight_layout()
    plt.savefig(out_png, dpi=180)
    plt.close()
    return out_png


# --- ALE validation (plot_ale_validation_be.py counterpart) ---------------

# reference map-name column values (plot_ale_validation_be.py:203-207)
# mapped to this package's AleMap kinds
_ALE_MAPS = {"fixed": "identity", "map_A": "accuracy_a",
             "map_B": "accuracy_b"}


def ale_validation_sweep(out_dir, mesh_file, order=1,
                         stability_dts=(0.2, 0.1, 0.05),
                         convergence_dts=(0.2, 0.1, 0.05, 0.025),
                         t_final=1.0, ref_levels=0, device=None):
    """Regenerate the ale_validation_be data contract from the port's own
    ALE MMS driver (the reference's data-producing drivers are dead
    makefile targets).  Runs diffusion_mms_ale on the unit-square GMSH
    file ``mesh_file`` over dt sweeps (on ``device``: the card unless
    "cpu") and writes the three CSVs the plotters consume into
    ``out_dir``."""
    import csv as _csv

    from ..apps.diffusion_mms_ale import run as run_ale

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(dt, ale_map):
        cfg = {"dt": dt, "t_final": t_final, "order": order,
               "ale_map": ale_map, "save_paraview": False,
               "serial_ref_levels": ref_levels, "mesh_file": mesh_file,
               "output_path": str(out_dir / f"run_{ale_map}_dt{dt:g}")}
        return run_ale(cfg, device=device), cfg["output_path"]

    # stability: per-dt ||u_h||_{L2(Omega(t))} histories on the moving map
    with open(out_dir / "stability_l2_history.csv", "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["dt", "time", "l2_norm"])
        for dt in stability_dts:
            _, run_dir = one(dt, "accuracy_a")
            hist = np.genfromtxt(Path(run_dir) / "error_history.csv",
                                 delimiter=",", names=True)
            for t, l2n in zip(np.atleast_1d(hist["time"]),
                              np.atleast_1d(hist["l2_norm"])):
                w.writerow([dt, t, l2n])

    # convergence: final-time L2 error vs dt on the moving map
    conv = {}
    for dt in convergence_dts:
        res, _ = one(dt, "accuracy_a")
        conv[dt] = res["final_l2"]
    with open(out_dir / "convergence_errors.csv", "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["dt", "l2_error"])
        for dt in sorted(conv, reverse=True):
            w.writerow([dt, conv[dt]])

    # accuracy: fixed grid vs both moving maps over the same dts
    with open(out_dir / "accuracy_errors.csv", "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["map", "dt", "l2_error"])
        for name, kind in _ALE_MAPS.items():
            for dt in convergence_dts:
                if name == "map_A" and dt in conv:
                    err = conv[dt]  # reuse the convergence runs
                else:
                    res, _ = one(dt, kind)
                    err = res["final_l2"]
                w.writerow([name, dt, err])
    return out_dir


def _slope_anchor(dt, err, slope=1.0):
    """Slope-p guide line anchored at the smallest-dt point."""
    i = int(np.argmin(dt))
    return err[i] * (dt / dt[i]) ** slope


def plot_ale_stability(stability_csv, out_png):
    """Fig. 7.1-style: ||u_h||_L2 vs time, one curve per dt."""
    plt = _plt()
    data = np.genfromtxt(stability_csv, delimiter=",", names=True)
    plt.figure(figsize=(8.8, 5.2))
    for dt in sorted(set(np.atleast_1d(data["dt"]).tolist()), reverse=True):
        sel = data["dt"] == dt
        order = np.argsort(data["time"][sel])
        plt.plot(data["time"][sel][order], data["l2_norm"][sel][order],
                 "-o", ms=3, lw=1.5, label=f"dt={dt:g}")
    plt.xlabel("Time t")
    plt.ylabel(r"$\|u_h\|_{L^2(\Omega(t))}$")
    plt.title("Stability (BE, ALE moving map)")
    plt.grid(True, alpha=0.25)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png, dpi=180)
    plt.close()
    return out_png


def plot_ale_convergence(convergence_csv, out_png):
    """Fig. 7.3-style: log-log final L2 error vs dt with a slope-1 guide
    and the observed global slope annotated."""
    plt = _plt()
    data = np.genfromtxt(convergence_csv, delimiter=",", names=True)
    dt = np.atleast_1d(data["dt"])
    err = np.atleast_1d(data["l2_error"])
    good = np.isfinite(dt) & np.isfinite(err) & (dt > 0) & (err > 0)
    dt, err = dt[good], err[good]
    idx = np.argsort(dt)[::-1]
    dt, err = dt[idx], err[idx]
    plt.figure(figsize=(7.2, 5.2))
    plt.loglog(dt, err, "-o", lw=1.8, ms=5, label="BE (ALE)")
    plt.loglog(dt, _slope_anchor(dt, err), "k--", lw=1.2, label="slope 1")
    if len(dt) >= 2:
        p = np.log(err[0] / err[-1]) / np.log(dt[0] / dt[-1])
        plt.annotate(f"observed slope ~ {p:.3f}", xy=(0.03, 0.05),
                     xycoords="axes fraction",
                     bbox=dict(boxstyle="round", fc="white", alpha=0.8))
    plt.xlabel(r"$\Delta t$")
    plt.ylabel(r"$L^2$ error at final time")
    plt.title("Convergence (BE)")
    plt.grid(True, which="both", alpha=0.25)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png, dpi=180)
    plt.close()
    return out_png


def plot_ale_accuracy(accuracy_csv, out_png):
    """Fig. 7.5-style: two log-log panels (map_A, map_B), each comparing
    the fixed-grid baseline against the moving-grid error vs dt."""
    plt = _plt()
    rows = np.genfromtxt(accuracy_csv, delimiter=",", names=True,
                         dtype=None, encoding="utf-8")
    names = np.atleast_1d(rows["map"]).astype(str)
    dts = np.atleast_1d(rows["dt"]).astype(float)
    errs = np.atleast_1d(rows["l2_error"]).astype(float)

    def series(name):
        sel = (names == name) & np.isfinite(dts) & np.isfinite(errs) \
            & (dts > 0) & (errs > 0)
        idx = np.argsort(dts[sel])[::-1]
        return dts[sel][idx], errs[sel][idx]

    fig, axes = plt.subplots(1, 2, figsize=(12.0, 4.8), sharey=True)
    for ax, mov in zip(axes, ("map_A", "map_B")):
        dt_f, err_f = series("fixed")
        dt_m, err_m = series(mov)
        if not len(dt_f) or not len(dt_m):
            raise ValueError(
                f"accuracy CSV needs 'fixed' and '{mov}' curves")
        ax.loglog(dt_f, err_f, "-o", lw=1.8, ms=4.5, label="fixed grid")
        ax.loglog(dt_m, err_m, "-s", lw=1.8, ms=4.5,
                  label=f"moving grid ({mov})")
        ax.loglog(dt_f, _slope_anchor(dt_f, err_f), "k--", lw=1.0,
                  label="slope 1")
        ax.set_title(f"Accuracy ({mov})")
        ax.set_xlabel(r"$\Delta t$")
        ax.set_ylabel(r"$L^2$ error")
        ax.grid(True, which="both", alpha=0.25)
    handles, labels = axes[0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper center", ncol=3, fontsize=9)
    fig.tight_layout()
    fig.savefig(out_png, dpi=180)
    plt.close(fig)
    return out_png


def plot_ale_validation(input_dir, output_dir=None):
    """Render whichever of the three ALE validation figures have data in
    ``input_dir`` (same skip-if-missing behavior as the reference CLI,
    plot_ale_validation_be.py:289-333).  Returns the written paths."""
    input_dir = Path(input_dir)
    output_dir = Path(output_dir) if output_dir else input_dir
    output_dir.mkdir(parents=True, exist_ok=True)
    written = []
    jobs = (
        ("stability_l2_history.csv", plot_ale_stability,
         "ale_validation_fig7_1_like_stability_be.png"),
        ("convergence_errors.csv", plot_ale_convergence,
         "ale_validation_fig7_3_like_convergence_be.png"),
        ("accuracy_errors.csv", plot_ale_accuracy,
         "ale_validation_fig7_5_like_accuracy_be.png"),
    )
    for csv_name, fn, png_name in jobs:
        src = input_dir / csv_name
        if not src.exists():
            print(f"Skipping {png_name} (missing {src}).")
            continue
        written.append(fn(src, output_dir / png_name))
        print(f"Wrote plot: {written[-1]}")
    if not written:
        raise SystemExit("No ALE validation CSVs found. Run "
                         "ale_validation_sweep first to generate data.")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=["l2", "newton_iters", "newton_per_step",
                                     "ale", "ale_sweep"])
    ap.add_argument("csv", help="CSV path (or directory for ale/ale_sweep)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh-file", default=None,
                    help="unit-square GMSH file of the ale_sweep runs")
    args = ap.parse_args(argv)
    if args.kind == "ale":
        plot_ale_validation(args.csv, args.out)
        return 0
    if args.kind == "ale_sweep":
        if args.mesh_file is None:
            ap.error("ale_sweep needs --mesh-file")
        ale_validation_sweep(args.csv, args.mesh_file)
        plot_ale_validation(args.csv, args.out)
        return 0
    out = args.out or str(Path(args.csv).with_suffix(".png"))
    if args.kind == "l2":
        plot_l2_vs_time(args.csv, out)
    elif args.kind == "newton_iters":
        plot_newton_iterations(args.csv, out)
    else:
        plot_newton_solves_per_step(args.csv, out)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
