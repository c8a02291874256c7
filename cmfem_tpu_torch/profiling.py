"""Where the time of slices 2, 3 and 6's paths goes, on one GPU.

    python -m cmfem_tpu_torch.profiling [--n 48] [--out FILE]
                                        [--sections operators,vcycle,...]

Profiles, with ``torch.profiler`` (host and device activity), at n^3
order-2 elements:

- one apply of each B1 operator: ``structured-pa`` (lattice gather, the
  B^T D B kernel, lattice scatter), the lattice gather and scatter alone,
  and ``pa`` (``u[eldofs_T]``, the kernel, ``index_add_``), float32;
- one warm GMRES backward-Euler step of ``vc_entry`` through each of the
  three operators, float32;
- one StructuredMG V-cycle of ``mg_solve``'s problem, float64, and each
  level's operator apply alone (host clock, device synchronized);
- one ``sumfact-zchain`` and one ``sumfact-zchain-periodic`` apply of
  ``operator_paths``, float32: how the device time splits between the
  z-chain kernel and the torch x/y matmuls around it;
- the steps of the ``linear_cd_transient`` driver (section ``driver``) on
  64 x 64 quads refined twice, order 2, float64, dt = 1e-3: the driver is
  run whole for 1 step and for 4 steps, each under the profiler (device
  activity only), and the difference is three steps' wall and device busy
  time with the set-up taken out; the same with ``scan_stepping``.

For each it prints the host wall per repetition (profiled, and unprofiled
where stated), the device busy time (the sum of the device activities'
own times: kernels and copies, one stream), the idle share 1 - busy/wall
and the device activities that take most time.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import require_cuda
from .apps import linear_cd_transient
from .core import make_cartesian_mesh_2d, write_gmsh
from .entry import KAPPA, OPERATORS, operator_paths, vc_entry
from .ops import BilinearForm
from .solvers.multigrid import StructuredMG


def _sync():
    torch.cuda.synchronize()


def host_ms(fn, reps=20, warmup=3):
    """Median host-clock ms of ``fn()`` with the device synchronized."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def profiled(label, fn, reps, out, top=12):
    """Profile ``reps`` calls of ``fn()`` (warmed once) and print the
    per-repetition wall, device busy time, idle share and top activities."""
    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    out(f"== {label}: wall {wall:.3f} ms/rep (profiled), device busy "
        f"{busy:.3f} ms/rep, idle share {1 - busy / wall:.3f}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        out(f"   {e.self_device_time_total / 1e3 / reps:9.3f} ms "
            f"{e.count / reps:8.1f} calls/rep  {e.key[:90]}")
    return wall, busy


def profile_operators(n, dev, rng, out):
    """B1 operator applies and the three vc GMRES steps."""
    for name in OPERATORS:
        step, (u0, *arrays) = vc_entry(n=n, order=2, operator=name,
                                       device=dev)
        out(f"-- vc_entry(n={n}, order=2, operator={name!r}) via {step.path}")
        u = torch.as_tensor(rng.standard_normal(u0.shape[0]),
                            dtype=u0.dtype, device=dev)
        profiled(f"{name} apply", lambda: step.fn(u, *arrays), 20, out)
        if name == "structured-pa":
            grid = step.op.grid
            u_eT = grid.gather(u)
            profiled("lattice gather only", lambda: grid.gather(u), 20, out)
            profiled("lattice scatter only", lambda: grid.scatter(u_eT), 20,
                     out)
        out(f"   {name} GMRES step unprofiled: "
            f"{host_ms(lambda: step(u0, *arrays), reps=5, warmup=1):.3f} "
            "ms")
        profiled(f"{name} GMRES step", lambda: step(u0, *arrays), 1, out)
        del step, u0, arrays, u
        torch.cuda.empty_cache()


def profile_vcycle(n, dev, rng, out):
    """One float64 V-cycle and each level's apply."""
    mg = StructuredMG.build(n, 2, lambda ops: BilinearForm(ops)
                            .add_diffusion(KAPPA), device=dev,
                            dtype=torch.float64)
    M, arrs = mg.bind()
    r = torch.as_tensor(rng.standard_normal(mg.levels[0]["diag"].shape[0]),
                        device=dev)
    out(f"-- StructuredMG n={n} order 2 f64, fine level via {mg.fine_path}; "
        f"V-cycle unprofiled {host_ms(lambda: M(r, arrs), reps=5):.3f} ms")
    profiled("one V-cycle f64", lambda: M(r, arrs), 1, out)
    for k, lvl in enumerate(mg.levels):
        fn, D, path = (lvl["op"].best_bind() if k == 0
                       else (*lvl["op"].bind(), "plain-chain"))
        v = torch.ones(lvl["diag"].shape[0], dtype=torch.float64, device=dev)
        out(f"   level {k} shape {lvl['shape']} {path}: apply "
            f"{host_ms(lambda: fn(v, D)):.3f} ms (host clock)")


def profile_zchain(n, dev, rng, out):
    """The z-chain applies of operator_paths at order 2."""
    P = operator_paths(n=n, order=2, device=dev)
    u = torch.as_tensor(rng.standard_normal(P.ndofs), dtype=torch.float32,
                        device=dev)
    for name in ("sumfact-zchain", "sumfact-zchain-periodic"):
        fn, arrays = P.paths[name]
        out(f"-- operator_paths(n={n}, order=2) {name}")
        profiled(f"{name} apply", lambda: fn(u, *arrays), 20, out)


def device_busy(fn):
    """(wall ms, device busy ms, value) of one call of ``fn()`` under the
    profiler, device activity only (the host side of a whole driver run is
    seconds of numpy)."""
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        _sync()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy, value


def profile_driver(n, dev, rng, out, n_quads=64, ref=2):
    """The steps of the linear_cd_transient driver, set-up differenced out."""
    with tempfile.TemporaryDirectory() as tmp:
        mesh = write_gmsh(make_cartesian_mesh_2d(n_quads, n_quads),
                          os.path.join(tmp, "quads.msh"))
        cfg = {"mesh_file": mesh, "serial_ref_levels": ref, "order": 2,
               "dt": 1e-3, "save_paraview": False,
               "output_path": os.path.join(tmp, "out")}
        run = lambda steps, scan: linear_cd_transient.run(
            {**cfg, "t_final": steps * 1e-3, "scan_stepping": scan},
            device=dev)
        run(1, False)  # warm: handles, allocator
        for scan in (False, True):
            w1, b1, _ = device_busy(lambda: run(1, scan))
            w4, b4, r = device_busy(lambda: run(4, scan))
            wall, busy = (w4 - w1) / 3, (b4 - b1) / 3
            steps = r["timing"][1:]
            out(f"== linear_cd_transient {'scan_stepping' if scan else 'host loop'}"
                f" ({r['fes'].nscalar} DOFs x 3 Peclet cases, f64): steps "
                f"2-4 wall {wall:.1f} ms/step, device busy {busy:.1f} "
                f"ms/step, idle share {1 - busy / wall:.3f}; whole runs "
                f"{w1:.0f} ms (1 step) and {w4:.0f} ms (4 steps); the "
                f"driver's own clock: solve "
                f"{1e3 * statistics.mean(t['solve'] for t in steps):.1f} "
                f"ms/step, errors and output "
                f"{1e3 * statistics.mean(t['errors_io'] for t in steps):.1f}"
                f" ms/step; Arnoldi steps per step "
                f"{sum(r['arnoldi']) / 4:.0f}")


SECTIONS = {"operators": profile_operators, "vcycle": profile_vcycle,
            "zchain": profile_zchain, "driver": profile_driver}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of: " + ", ".join(SECTIONS))
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args(argv)
    dev = require_cuda()
    lines = []

    def out(s):
        print(s, flush=True)
        lines.append(s)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(0)
    for name in args.sections.split(","):
        SECTIONS[name](args.n, dev, rng, out)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
