"""One accuracy table for the analytic-solution drivers.

Port of the JAX package's ``scripts/accuracy_table.py``.  For every driver
with an analytic (or series) solution, on the same meshes and configs:

  col A  float64 error against the analytic solution, on the CPU
  col B  float32 error against the same solution, on the card
  col C  the float32 field's rel-L2 deviation from the float64 field

and the ablation case-1 smoke deck, which has no analytic solution (col C
only).  The ablation drivers run in float64 only (float32 is refused by
design), so that row runs float64 on both sides and its col C is the
card's drift from the CPU in float64 (``ablation_case1_smoke (f64 card vs
f64 cpu)``).

Inputs, in place of the reference's: the unit square as 22 x 22 x 2
triangles for unit_square.msh (968 elements, the reference's has 938),
the disc of ``common.disc_mesh(22)`` for unit_circle.msh, the same square
scaled to 0.01 for square_0p01.msh, and for the ablation smoke deck the
graded strip ``make_strip_mesh_2d(11, 239)`` with the synthetic TACOT deck
(dt 0.1, t_final 0.3).

Run the float64 mode first (the CPU, which it refuses to run without
--cpu or CMFEM_FORCE_CPU=1), then the float32 mode (the card, unless
--cpu), with the same --out-dir:

    python -m cmfem_tpu_torch.scripts.accuracy_table f64 --cpu --out-dir DIR
    python -m cmfem_tpu_torch.scripts.accuracy_table f32 --out-dir DIR

The first writes DIR/acc_ref.npz, the second DIR/accuracy.json.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch

from . import common

ABLATION = "ablation_case1_smoke (f64 card vs f64 cpu)"
# how diffusion_mms_ale stops when its linear solve neither converges nor
# stagnates (the one stop a float32 row is recorded with)
SOLVER_FAILED = "Linear solver failed"


def cases(mesh_dir, n=22):
    """(name, module, cfg, error_getter, field_key) per driver, the JAX
    study's configs on meshes written into ``mesh_dir``."""
    square = common.square_file(mesh_dir, n)
    disc = common.disc_file(mesh_dir, n)
    square01 = common.square_file(mesh_dir, n, scale=0.01)
    return [
        ("linear_cd_2d", "linear_cd_2d",
         {"mesh_file": square, "order": 2},
         lambda o: o["rel_l2"], "u"),
        ("linear_cd_2d_circle", "linear_cd_2d_circle",
         {"mesh_file": disc, "order": 2},
         lambda o: o["rel_l2"], "u"),
        ("linear_cd_transient", "linear_cd_transient",
         {"mesh_file": square, "order": 2, "dt": 0.01, "t_final": 0.05},
         lambda o: max(float(o["final_errors"][k]) for k in (3, 5, 7)),
         "c"),
        ("diffusion_mms", "diffusion_mms",
         {"mesh_file": square, "order": 2, "alpha": 0.1, "dt": 0.025,
          "t_final": 0.1},
         lambda o: o["final_l2"], "u"),
        ("diffusion_mms_ale", "diffusion_mms_ale",
         {"mesh_file": square, "order": 1, "serial_ref_levels": 1,
          "alpha": 0.1, "dt": 0.05, "t_final": 0.25,
          "ale_map": "accuracy_b"},
         lambda o: o["final_l2"], "u"),
        ("nonlinear_diffusion", "nonlinear_diffusion",
         {"mesh_file": square01, "order": 2, "dt": 0.1, "t_final": 0.3,
          "L": 0.01, "series_terms": 400, "newton_print_level": 0},
         lambda o: float(o["final"][1]), "u"),
    ]


def run_case(modname, cfg, err, fkey, out_path, device, dtype):
    """One driver run: {"err_vs_analytic", "field" (float64 numpy)}."""
    mod = importlib.import_module(f"cmfem_tpu_torch.apps.{modname}")
    o = mod.run({**cfg, "save_paraview": False, "output_path": out_path},
                device=device, dtype=dtype)
    return {"err_vs_analytic": float(err(o)),
            "field": np.asarray(o[fkey], np.float64)}


def ablation_field(work_dir, device):
    """The ablation case-1 smoke deck (float64): the final (T, p)."""
    from ..apps.ablation_case1 import run

    cfg = {"mesh_file": common.strip_file(work_dir),
           "material_file": common.TACOT_DECK, "order": 1, "dt": 0.1,
           "t_final": 0.3, "bdr_attr_top": common.STRIP_TOP,
           "probe_x": 0.00125, "newton_print_level": 0,
           "save_paraview": False,
           "output_path": os.path.join(work_dir, "abl")}
    o = run(cfg, device=device)
    return np.concatenate([np.asarray(o["T"], np.float64),
                           np.asarray(o["p"], np.float64)])


def run_all(mode, device, work_dir, names=None):
    """Every row (or those in ``names``) in ``mode`` ("f64": float64,
    "f32": float32 for the analytic drivers) on ``device``.  A float32 run
    that a driver stops (its linear solve neither converged nor stopped on
    the working-precision floor: ``SOLVER_FAILED``) is recorded as
    {"failed": message}; any other error propagates."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    out = {}
    for name, modname, cfg, err, fkey in cases(work_dir):
        if names is None or name in names:
            try:
                out[name] = run_case(modname, cfg, err, fkey,
                                     os.path.join(work_dir, name), device,
                                     dtype)
            except RuntimeError as e:
                if mode == "f64" or not str(e).startswith(SOLVER_FAILED):
                    raise
                out[name] = {"failed": str(e)}
    if names is None or ABLATION in names:
        out[ABLATION] = {"err_vs_analytic": None,
                         "field": ablation_field(work_dir, device)}
    return out


def main(argv=None):
    ap = common.add_run_args(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("mode", nargs="?", default="f32", choices=("f64", "f32"))
    args = ap.parse_args(argv)
    out_dir = common.out_dir(args.out_dir, "accuracy")
    ref_npz = os.path.join(out_dir, "acc_ref.npz")
    if args.mode == "f64":
        res = run_all("f64", common.cpu_only(
            args.cpu, "accuracy_table f64 is column A, the float64 oracle "
            "on the CPU"), out_dir)
        np.savez(ref_npz,
                 **{f"{k}__field": v["field"] for k, v in res.items()},
                 **{f"{k}__err": np.float64(
                     v["err_vs_analytic"]
                     if v["err_vs_analytic"] is not None else np.nan)
                    for k, v in res.items()})
        print(json.dumps({k: v["err_vs_analytic"] for k, v in res.items()}))
        print(f"wrote {ref_npz}")
        return 0

    ref = np.load(ref_npz)
    device = common.run_device(args.cpu)
    res = run_all("f32", device, out_dir)
    table = {"platform_f32": device.type, "card": common.card(device)}
    for k, v in res.items():
        if "failed" in v:
            table[k] = {"f64_cpu_err_vs_analytic": float(ref[f"{k}__err"]),
                        "f32_failed": v["failed"]}
            continue
        fr = ref[f"{k}__field"]
        dev = float(np.linalg.norm(v["field"] - fr)
                    / max(np.linalg.norm(fr), 1e-300))
        ea = ref[f"{k}__err"]
        table[k] = {
            "f64_cpu_err_vs_analytic": None if np.isnan(ea) else float(ea),
            "f32_err_vs_analytic": v["err_vs_analytic"],
            "f32_rel_l2_dev_vs_f64_oracle": dev,
        }
    print(json.dumps(table, indent=1))
    path = common.write_json(os.path.join(out_dir, "accuracy.json"), table)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
