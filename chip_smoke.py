#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmfem_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. checks: a CUDA device, the card's name and power limit (nvidia-smi),
     the kernel built from cmfem_tpu_torch/csrc/ (build time printed);
  2. kernel against plain version: orders 1-4 on the (3,4,5) and (6,6,6)
     grids, z-periodic and full D, float64 to 1e-12 max|y| and float32 to
     1e-5 max|y| (float32 sums taken in another order, <= 125 terms per
     output);
  3. the main path: ``entry(n=48, order=2)`` (912,673 DOFs, float32), one
     GMRES backward-Euler step through the kernel, checked for convergence
     and against the same step through the plain version (1e-4 relative);
  4. the SPD step (``spd_step``) with CG at the same size;
  5. timings: setup, median apply of kernel and plain version (CUDA
     events), step time.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.  Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cmfem_tpu_torch  # noqa: E402
from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d  # noqa: E402
from cmfem_tpu_torch.entry import BETA, DT, entry, spd_step  # noqa: E402
from cmfem_tpu_torch.kernels import build as kbuild  # noqa: E402
from cmfem_tpu_torch.kernels import sumfact as ksum  # noqa: E402
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps  # noqa: E402
from cmfem_tpu_torch.ops.sumfact import SumFactoredOperator  # noqa: E402

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def log(msg):
    print(msg, flush=True)


def cdr_operator(n, order, device, dtype):
    nx, ny, nz = n
    fes = FESpace(make_cartesian_mesh_3d(nx, ny, nz), order)
    ops = SpaceOps(fes, quad_order=2 * order, device=device)
    data = (BilinearForm(ops).add_mass(1.0).add_convection(BETA, alpha=DT)
            .add_diffusion(0.1 * DT).assemble())
    return SumFactoredOperator(ops, data, nx, ny, nz, order, device=device,
                               dtype=dtype)


def rel_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def compare(op, periodic, u):
    """max|kernel - plain| / max|plain| of one apply, and max|kernel - plain|."""
    fk, Dk = op.bind_kernel(use_periodic=periodic)
    fp, Dp = op.bind(use_periodic=periodic)
    yk = fk(u, Dk)
    yp = fp(u, Dp)
    torch.cuda.synchronize()
    assert torch.isfinite(yk).all(), "kernel output is not finite"
    return rel_err(yk, yp), float((yk - yp).abs().max())


def median_ms(fn, reps=50, warmup=10):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main():
    # -- 1. checks --------------------------------------------------------
    dev = cmfem_tpu_torch.require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ksum.build()
    secs, nvcc_log = kbuild.build_info(ksum.LIB_NAME)
    log(f"phase 1: kernel library {ksum.LIB_NAME} built/loaded in "
        f"{secs:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 2. kernel against plain version ------------------------------------
    gen = np.random.default_rng(0)
    for n in ((3, 4, 5), (6, 6, 6)):
        for order in (1, 2, 3, 4):
            for dtype in (torch.float64, torch.float32):
                op = cdr_operator(n, order, dev, dtype)
                assert op.compressed and op.z_periodic, (n, order)
                u = torch.as_tensor(gen.standard_normal(op.ndofs),
                                    dtype=dtype, device=dev)
                for periodic in (True, False):
                    err, _ = compare(op, periodic, u)
                    ok = err <= TOL[dtype]
                    log(f"phase 2: n={n} p={order} {str(dtype)[6:]} "
                        f"{'z-periodic' if periodic else 'full D'}: "
                        f"max|k-p|/max|p| = {err:.3e} (tol {TOL[dtype]:.0e})"
                        f" {'ok' if ok else 'FAIL'}")
                    assert ok, (n, order, dtype, periodic, err)

    # -- 3. the main path ---------------------------------------------------
    t0 = time.perf_counter()
    step, (u0, D) = entry(n=48, order=2, dtype=torch.float32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    op = step.op
    log(f"phase 3: entry(n=48, order=2) ndofs={op.ndofs} setup {setup_s:.2f} s"
        f"; best_bind -> {step.path}; compressed={op.compressed} "
        f"z_periodic={op.z_periodic} periodic={op.periodic}")
    assert op.ndofs == 912_673
    assert step.path == "cuda-sumfact-zperiodic", step.path
    assert op.compressed and op.z_periodic
    # a first step pays one-time costs (cuBLAS handles, allocator growth)
    t0 = time.perf_counter()
    step(u0, D)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    ksum.launches = 0
    t0 = time.perf_counter()
    res = step(u0, D)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    main_launches = ksum.launches
    A = step.apply_A(step.fn, D)
    B = torch.where(step.mask, 0.0, u0)
    rel_pre = float(torch.linalg.vector_norm(step.M(B - A(res.x)))
                    / torch.linalg.vector_norm(step.M(B)))
    rel_true = float(torch.linalg.vector_norm(B - A(res.x))
                     / torch.linalg.vector_norm(B))
    log(f"phase 3: GMRES step {step_s:.4f} s (first step "
        f"{first_step_s:.4f} s), cycles={res.iters} "
        f"arnoldi={res.inner_iters} converged={res.converged} "
        f"stagnated={res.stagnated} rel_residual={res.rel_residual:.3e}; "
        f"explicit |M(B-Ax)|/|MB| = {rel_pre:.3e}, |B-Ax|/|B| = "
        f"{rel_true:.3e}; kernel launches {main_launches}")
    assert main_launches > 0, "the main path did not launch the kernel"
    assert res.converged and torch.isfinite(res.x).all()
    assert rel_pre <= 2e-6, rel_pre
    fnp, Dp = op.bind(use_periodic=True)
    t0 = time.perf_counter()
    res_p = step.solve(u0, fnp, Dp)
    torch.cuda.synchronize()
    plain_step_s = time.perf_counter() - t0
    dx = rel_err(res.x, res_p.x)
    dx2 = float(torch.linalg.vector_norm(res.x - res_p.x)
                / torch.linalg.vector_norm(res_p.x))
    log(f"phase 3: plain-version step {plain_step_s:.4f} s, "
        f"arnoldi={res_p.inner_iters} converged={res_p.converged}; "
        f"kernel vs plain solution: max rel {dx:.3e}, 2-norm rel {dx2:.3e}")
    assert res_p.converged and dx2 <= 1e-4, dx2

    # -- 4. SPD step ----------------------------------------------------------
    t0 = time.perf_counter()
    sstep, (su0, sD) = spd_step(n=48, order=2, dtype=torch.float32)
    torch.cuda.synchronize()
    spd_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sres = sstep(su0, sD)
    torch.cuda.synchronize()
    spd_s = time.perf_counter() - t0
    log(f"phase 4: SPD CG step via {sstep.path}: setup {spd_setup_s:.2f} s, "
        f"step {spd_s:.4f} s, iters={sres.iters} converged={sres.converged} "
        f"rel_residual={sres.rel_residual:.3e}")
    assert sstep.path == "cuda-sumfact-zperiodic", sstep.path
    assert sres.converged and torch.isfinite(sres.x).all()

    # -- 5. timings at the main-path shape ------------------------------------
    u = torch.as_tensor(gen.standard_normal(op.ndofs), dtype=torch.float32,
                        device=dev)
    err, max_abs = compare(op, True, u)
    log(f"phase 5: 48^3 p=2 f32 z-periodic kernel vs plain: "
        f"max|k-p|/max|p| = {err:.3e}, max|k-p| = {max_abs:.3e}")
    assert err <= TOL[torch.float32], err
    fk, Dk = op.bind_kernel(use_periodic=True)
    fp, Dp = op.bind(use_periodic=True)
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        f, Darg = (fk, Dk) if name == "kernel" else (fp, Dp)
        times[name].append(median_ms(lambda: f(u, Darg)))
    k_ms = min(times["kernel"])
    p_ms = min(times["plain"])
    log(f"phase 5: median apply (ms, two rounds): kernel {times['kernel']}, "
        f"plain {times['plain']}; kernel {op.ndofs / k_ms / 1e3:.1f} MDOF/s,"
        f" plain {op.ndofs / p_ms / 1e3:.1f} MDOF/s; setup {setup_s:.2f} s,"
        f" GMRES step {step_s:.4f} s, SPD step {spd_s:.4f} s")

    log(json.dumps({"kernels": [{
        "name": "sumfact_fused",
        "route": "cuda",
        "source": "cmfem_tpu_torch/csrc/sumfact_fused.cu",
        "replaces": "cmfem_tpu/ops/sumfact.py:563",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
