"""The readings a cell's output limits are set from.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 5 [--out chiprun_out/x.json]

builds the cell's program once, then for each seed makes that seed's
inputs, runs a window of ``--seconds`` and the cell's output check (the
lower readings: the program's sound runs), and for each control seed the
same with the plain reference put in the program's place in the
configuration's ``control_dtype``, the precision below its own (the upper
readings).  Prints one JSON line (and writes it to ``--out``).  The
benchmark's own runs never run the control."""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, seconds):
    rows = []
    for s in seeds:
        cell.seed_inputs(s)
        rec = cell.window(seconds)
        t0 = time.perf_counter()
        checks = {n: v for n, v, _ in cell.check()}
        rows.append({"seed": s, "attempted": rec["attempted"],
                     "failed": rec["failed"], "window_s": rec["window_s"],
                     "check_s": time.perf_counter() - t0, "checks": checks})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None):
    import argparse

    sys.path.insert(0, ROOT)
    from bench_port import harness

    harness.setup_environment(ROOT)
    import torch

    ap = argparse.ArgumentParser(prog="bench_port/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]

    device = torch.device("cuda", 0)
    bench = harness.load_benchmark()
    wl = harness.find(bench, "workloads", args.workload)
    with open(os.path.join(ROOT, harness.find(bench, "configs",
                                              wl["config"])["file"])) as f:
        config = json.load(f)
    workload = harness.load_json("workloads", args.workload)
    kind = harness.load_module("kinds", workload["kind"])
    first = (seeds or cseeds)[0]
    cell = kind.Cell(config, workload, first, device)
    cell.warm()
    out = {"workload": args.workload,
           "kind": torch.cuda.get_device_name(device),
           "setup_s": time.perf_counter() - T_START,
           "program": readings(cell, seeds, args.seconds)}
    if cseeds:
        cell.use_control()
        out["control"] = readings(cell, cseeds, args.seconds)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
