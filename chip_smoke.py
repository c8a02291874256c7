#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmfem_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. checks: a CUDA device, the card's name and power limit (nvidia-smi),
     the four kernel libraries built from cmfem_tpu_torch/csrc/, one nvcc
     each, all started together (build time and ptxas registers/spills
     printed; the sum-factorization lane kernel's instantiations and the
     float32 instantiations of the tiled B^T D B kernel, hexes at orders
     2-4, must not spill; that kernel's resident blocks per SM);
  2. the sum-factorization kernel (one launch of the lane kernel) against
     its plain version, orders 1-4 on the (3,4,5), (6,6,6) and (7,5,9) grids ((7,5,9)
     is ragged: nx is no multiple of the elements per block): the
     constant-coefficient CDR form
     (z-periodic and full D), the form with kappa = 0.1 + z^2 (full D that
     varies by element along z) and the same form on a distorted lattice
     (full D that varies along x, y and z); float64 to 1e-12 max|y|,
     float32 to 1e-5 max|y| (sums taken in another order, <= 125 terms per
     output; the lane kernel adds shared DOFs with atomics, in an order that
     changes from run to run); on the same operators (phase 8a) the z-chain kernel against
     its plain version on the same x/y fields, and the whole
     ``bind_zchain`` apply against ``bind()``, to the same tolerances;
  3. the B^T D B kernel against its plain version at every shape of
     ``kernels.btdb.KERNEL_SHAPES`` (the (m, nd, nq) of the JAX package's
     spaces at orders 1-4): operators on hexes (3,4,5), quads (7,5),
     triangles (7,5) and tets (two tets refined twice, ``make_tet_mesh(2)``),
     orders 1-4 under q1 = p + 1, p + 2 and 3 points per axis, variable
     conductivity; each says ``path == "cuda-btdb"``, float64 to 1e-12
     max|y|, float32 to 1e-5 max|y| (each output sums m*nq <= 864
     products twice, in another order), and its apply agrees with
     ``BilinearForm.apply`` to the same tolerances, as does the operator
     built with ``use_kernel=False`` (``path == "plain-btdb"``, no launch);
     ``StructuredPAOperator`` at p + 2 points per axis takes the kernel; a
     shape outside the set (an order-5 quad) is refused in
     ``btdb_apply``'s words; the 32 shapes this slice added timed alone at
     110,592 elements (float32, kernel and plain version in turns, CUDA
     graphs), each beside its bound;
  4. slice 1's main path: ``entry(n=48, order=2)`` (912,673 DOFs, float32),
     one GMRES backward-Euler step through the z-periodic kernel, checked
     for convergence and against the same step through the plain version;
     the SPD step (``spd_step``) with CG at the same size;
  5. slice 2's operator path: ``vc_entry(n=48, order=2)`` (kappa = 0.1 +
     z^2, float32) through the three operators "sumfact" (full-D kernel),
     "structured-pa" and "pa" (B^T D B kernel): applies agree to 1e-5
     max|y|, each GMRES step converges (|M(B-Ax)|/|MB| <= 2e-6), the three
     solutions agree to 1e-4;
  6. slice 2's multigrid path: ``mg_solve`` (MMS, -div(kappa grad u) = f)
     with StructuredMG-PCG in float64 at n=24 and n=48 (<= 20 iterations,
     L2 rate log2(e24/e48) >= 2.7), the fine level's float64 full-D kernel
     against its plain chain at n=48 (1e-12 max|y|), Jacobi-PCG at n=48,
     one float32 MG solve at n=48 (finite, within 1e-3 of the float64
     solution);
  7. timings at the 48^3 shapes: each kernel and its plain version, in
     turns, as device time per call (a CUDA graph of 10 calls replayed
     between two events) and one kernel call with its host enqueue; the
     B^T D B applies with their gather and scatter (one call, events);
     step, solve and setup times; peak device memory;
  8. slice 3: (b) ``operator_paths(n=48, order)`` for orders 2, 3 and 4,
     float32: every path's apply of one seeded vector agrees with the
     plain ``sumfact`` chain to 1e-5 max|y| and moves its own launch
     counter; median apply ms of one call (CUDA events, in turns against
     ``sumfact``) and MDOF/s of each path; the z-chain kernel alone on its
     x/y fields beside its plain version, and B1 (the tiled design) at
     orders 3 and 4 beside its plain version (timed as in 7), with its
     share of the bound; ``PAOperator.bind()``'s apply alone in entity
     numbering (``u[eldofs_T]``, B1, ``index_add_``; device time as in 7)
     beside B1's, at every order; the element-local kernel on Dz
     (B2) and on full D (B3) alone (device time as in 7), each beside its
     bound and its share of the bound; peak
     device memory of each order; (c) the BE steps at 48^3, orders 3 and
     4: ``vc_entry`` through ``best_bind`` (full-D kernel) and through
     ``bind_zchain()``, ``entry`` through ``best_bind`` (Dz kernel) and
     through ``bind_zchain(use_periodic=True)``: each converges
     (|M(B-Ax)|/|MB| <= 2e-6; a GMRES that stops on stagnation at the
     float32 floor 16 eps = 1.907e-6 counts if it meets that) and the two
     solutions of a form agree to 1e-4 in the 2-norm; the ``best_bind``
     step runs twice; then the same kappa(z) step
     through ``vc_entry(operator="pa")``, the element-batched operator in
     entity numbering on the B^T D B kernel: it launches that kernel only,
     converges like the others, and its solution, moved to the lattice,
     agrees with the ``best_bind`` step's to 1e-4;
  9. slice 6, the application drivers through ``run(cfg)`` on the card, in
     float64, on GMSH files written here: (a) ``linear_cd_transient`` on
     64 x 64 quads refined twice (65,536 elements, order 2, 263,169 DOFs,
     three Peclet cases), dt = 1e-3, 3 backward-Euler steps with
     Jacobi-GMRES in the host loop and again with ``scan_stepping``: every
     solve converges, the two CSVs agree to 1e-10, the relative L2 errors
     are finite and no larger than the JAX driver's on this mesh (times
     1.001); one SDIRK2 step; (b) ``diffusion_mms`` on 32 x 32 x 2 triangles
     refined once, order 2, 3 steps with Jacobi-CG and with ``GeometricMG``
     (three levels): both converge and the final L2 errors agree to 1e-8;
     the point locator that ran is printed; (c) ``linear_cd_2d`` (order 3,
     64 x 64 quads) and ``linear_cd_2d_circle`` (order 2, the square mapped
     onto the unit disc, 32 x 32 x 2 triangles refined once): GMRES
     converges.  The drivers apply their forms with torch einsums and
     ``index_add_``: no kernel is on this path, and no launch count moves;
 10. slice 7, the nonlinear, vector, ALE and Q* drivers through ``run``,
     float64 (``run_nonlinear_drivers``, sizes as arguments): (a)
     ``nonlinear_diffusion`` on 128 x 128 quads of side 0.01, order 2
     (66,049 DOFs), dt 0.1, 2 backward-Euler steps of full Newton (AD
     element Jacobians for the Jacobi diagonal, GMRES on the AD JVP): every
     Newton solve converges, rel L2 < 2e-2 and equal to the JAX driver's to
     1e-6 relative, equal Newton counts; (b) ``elasticity``, the 2D default
     (40 x 4 quads, order 2) and a 40 x 4 x 4 hex cantilever, order 2:
     Jacobi-CG converges (or stops at the float64 floor within 1e-9) under
     solver_maxiter, the tip deflection within 8% of Euler-Bernoulli; (c)
     ``diffusion_mms_ale`` on 64 x 64 x 2 triangles refined once, order 1
     (16,641 DOFs), dt 0.05, 3 steps: ``identity`` equals ``diffusion_mms``
     to 1e-8, ``accuracy_a``'s L2 < 2e-2 and equal to the JAX driver's to
     1e-6 relative; (d) ``qstar_blowing_1d`` at 512 elements: converged,
     |sdot error| < 5e-3, sdot equal to the JAX driver's to 1e-10 relative,
     equal Newton count.  No kernel lies on these paths; no launch count
     moves.
 11. slice 8, ablation case 1 through ``run(cfg)``, float64
     (``run_ablation_case1``, sizes as arguments), on the TACOT strip
     (``make_strip_mesh_2d``: 11 x 239 order-1 quads graded toward the
     heated top, 2.5 mm x 0.05 m, 5,760 (T, p) DOFs) with the synthetic deck
     ``tests/fixtures/tacot_synthetic.json`` (read without PyYAML), dt 0.1,
     the default wall schedule: (a) 6 steps through the host LU (AD
     Jacobians on the card, scipy ``splu``): every Newton solve converges,
     the last probe temperatures, m_dot_g and the two front depths equal the
     JAX driver's to 1e-7 relative with equal Newton counts; (b) the same run
     with ``scan_stepping`` (``BlockTridiagDirect`` on the card): its CSVs
     agree with (a)'s to 1e-8; (c) point-block GMRES(400) at rtol 1e-12 on
     the first Newton system of step 1, through ``make_block_linear_solver``:
     converged, its direction equal to the host LU's to 1e-8, its iterations
     and seconds printed; (d) the strip refined twice (86,130 DOFs) through
     ``scan_stepping``, 2 steps: seconds per step with the Newton split, the
     factorization's and the solve's ms per call, peak device memory, and
     the residual through the generic and the lattice path in turns (equal
     to 1e-12).  No kernel lies on this path; no launch count moves.
 12. slice 9, ablation case 2.1 through ``run(cfg)``, float64
     (``run_ablation_case21``, sizes as arguments), on phase 11's strip and
     deck with the synthetic B' table and the schedule fixture
     ``tests/fixtures/surface_bc_case21.dat``, dt 0.1, 6 steps (1-4 on the
     chemistry-blowing branch, step 4 on the 0.4 s node, 5-6 cooling): (a)
     the eager host-LU path (element and SEB face blocks into ``splu``) with
     ``jacobian_check``: every Newton solve converges, the face check skips
     the first blowing step (B'g = 0 clamps at a uniform p) and passes the
     cooling branch, the probes, m_dot_g, B'g, q_conv, q_surf and fronts at
     t = 0.4 and 0.6 equal the JAX driver's to 1e-7 relative with equal
     Newton counts; (b) ``scan_stepping`` (``BlockTridiagDirect`` with the
     face blocks): its probe, mass, boundary and Newton CSVs equal (a)'s to
     1e-8 across the branch switch; the blowing branch's face check passes
     at the state after step 2 (bc at t = 0.3), and the element and face
     Jacobians, the residual, one B' lookup and one diagnostics row are
     timed alone there; (c) an eager run resumed from (a)'s t = 0.3
     checkpoint ends at (a)'s T (2e-5 K) and p (1e-7 relative); peak device
     memory.  No kernel lies on this path; no launch count moves.
 13. slice 10, ablation case 2.2 (surface recession on a moving mesh)
     through ``run(cfg)``, float64 (``run_ablation_case22``, sizes as
     arguments), on phase 11's strip split into triangles
     (``make_strip_mesh_2d(11, 239, geom="triangle")``: 5,258 triangles,
     5,760 (T, p) DOFs), phase 12's deck, B' table and schedule, dt 0.1, 6
     steps (1-4 recede on the chemistry-blowing branch, 5-6 cool and stand
     still): (a) the eager host-LU path (the handler's cold-started
     smoothing CG on the card, the host remap, ``splu`` over the element
     and face blocks on the moved mesh) with ``jacobian_check``: the
     surface recedes from step 1, every step moves or stands still as the
     schedule says, the rows at t = 0.4 and 0.6 (probes, m_dot_g, m_dot_c,
     B'g, B'c, q_conv, q_surf, fronts, recession, top height) equal the JAX
     driver's within the deviation of ROADMAP known problem 9 (the port's
     smoothing CG runs to its tolerance, the JAX package's stops on its
     flat-window exit at this size): 2e-4 relative, the fronts 5e-8 m,
     with equal Newton counts; (b) ``scan_stepping`` (the warm-started
     smoothing, ``TriStripRemap`` and ``TrackedSampler`` on the card,
     ``BlockTridiagDirect``): the same rows equal the JAX scan path's
     within the same, with equal Newton counts; against (a) the same moves
     and Newton counts, T and p within 1e-8 of their largest values, the
     recession within 1e-8 relative and the vertices within 1e-12 of their
     largest value (both paths at the converged mesh velocity; the scan
     path samples the fronts on the initial line, so its CSVs differ
     there); the pieces of a receding step timed alone; (c) an eager run
     resumed from (a)'s t = 0.3 ALE checkpoint ends at (a)'s T, p and
     vertices; (d) the study variant (GCL storage, the Amaryllis metrics
     against ``tests/fixtures/amaryllis_mass_synthetic.dat``), 1 step;
     peak device memory; (e) the smoothing CG of (b)'s pieces repeated 10
     times cold and 10 times warm on identical inputs: the iteration counts
     and the iterates are the same bit for bit (ROADMAP C10).  No kernel
     lies on this path; no launch count moves.
 14. slice 11 (``run_linemg``, ``run_distributed``, ``run_gloo_on_card``):
     (a) ``BlockNewtonKrylov(pc="linemg")``, GMRES(400) at rtol 1e-12, on
     the first Newton system of 11a (5,760 DOFs) and of 11d's strip (86,130
     DOFs): the inner iterations equal the JAX package's on the same
     systems (``JAX_14A_LINEMG``), beside 11c's point-block count; set-up
     ms and solve s; the true relative residual on the host matrix; the
     direction equal to the direct solve's (host ``splu``,
     ``BlockTridiagDirect``) to 1e-8; then the line kernels outside the
     counted runs (``linemg_kernels_vs_plain``): against their plain
     versions at the finest level (1e-8), and at every level of both
     hierarchies the kernel solve's line residual at most 1e-10 and within
     10 times the plain solve's on the same factors, a repeated solve equal
     bit for bit, and the kernel's launch geometry its wrapper's; at
     every level of the 86,130-DOF hierarchy (NX 45 -> 1) each kernel's
     device ms (a replayed CUDA graph) and ms a call beside its bound, and
     ``line_factor``'s chain floor from the slope between NY = 240 and 957
     at NX = 1 (``factor_chain_floor``); (b) the distributed operator layer in
     a world of one rank over NCCL, at 48^3, order 2 (912,673 DOFs), float64
     and float32: ``ShardedPoissonApply`` (CDR form) and
     ``DofPartitionedOperator`` (SPD form) against ``BilinearForm.apply``,
     ``ShardedSumFactOperator`` against ``SumFactoredOperator``'s plain chain
     (float64 1e-12, float32 1e-5 of max|y|), a Jacobi-CG on the
     ``DofPartitionedOperator`` with the single-device CG's iteration count
     (x to 1e-8), each apply's ms beside the single-device path's, peak
     device memory; (c) two gloo ranks on the one card (NCCL takes one rank
     per card), 8^3 at order 2: each operator against its single-device
     apply (1e-12); the one failure passed over is gloo's transport refusing
     the z-split exchange of CUDA tensors, named with gloo's words, and any
     other error fails the phase.  (a) moves the line kernels' counts
     only; no kernel lies on (b) and (c), and no launch count moves.
 15. slice 12, the distributed ablation Newton
     (``run_distributed_ablation``, ``run_ablation_gloo_on_card``),
     float64: (a) in a world of one NCCL rank, at the deck's 5,760 DOFs:
     on the first Newton system of case 2.1's step 1 (SEB,
     chemistry-blowing branch) ``ShardedAblationNewton`` and
     ``DofPartitionedAblationNewton``: the residual = the single-device
     residual to 1e-12 of max|R|; on case 1's first system the same and
     the Newton direction (GMRES rtol 1e-13) = ``splu``'s per field to
     1e-7; ms per residual, ``prepare`` and
     matvec call, GMRES iterations, per-rank floats; one case-1 step with
     ``dof_partition: 1`` and one case-2.2 step with ``sharding_devices:
     1`` through ``run(cfg)``: their first-step rows = 11a's and 13a's (T
     to 1e-6, 2.2's pressure probes and case 1's m_dot_g to 1e-8), the same
     linear solves, s per step with the Newton split; (b) on case 1's strip
     refined twice (86,130 DOFs): each class's residual, ``prepare``'s
     Je_s, pb and s and one matvec = the single-device path's
     (``BlockNewtonKrylov`` on the element blocks) to 1e-12, ms per call
     beside it, peak device memory; (c) two gloo ranks on the one card:
     ``entry.dryrun_ablation_rank`` (two element-sharded iterates, the
     DOF-partitioned one and a receded case-2.2 one against them, to 1e-6)
     and a ``save_sharded``/``load_sharded`` round trip of a
     DOF-partitioned state, bit for bit; a load at world size 1 is refused
     in the words "world size"; (c) runs beside (a) and (b).  Any error
     fails the phase; no kernel lies on it, and no launch count moves.
 16. slice 13, the study scripts of ``cmfem_tpu_torch.scripts``
     (``run_scripts``, sizes as arguments): (a) the refinement study
     (``blocksolve_refinement.run_study``) at refine 0 on the graded strip
     (5,760 DOFs), both synthetic states, line MG and the point blocks at
     its rtol 1e-6, one untimed pass (no warm-up, no kernel timing; 14a
     times the kernels): every solve converged, line MG launching the line
     kernels (and the point blocks none), the inner iterations printed
     beside the JAX study's on the reference deck; (b)
     ``fullrun.main(["case1", "--eager", "--t-final", "0.3", ...])``: exit
     0, the artifact ``sane`` with 3 steps; (c) ``compensated_dots.run(12,
     card)``: the float32 solutions with the default and the Neumaier dot
     within 1e-4 of the float64 oracle (CPU).  Only the line kernels'
     counts move, and they equal the sum of the study's per-solve counts.
Each main path (4, 5, 6, 8b's applies, 8c, 14a, 16) runs with every launch
count set to 0 just before it and read just after.  The last lines are the kernels'
JSON record (each kernel's launches on the main paths, error, times, and
its bound: the larger of the bytes it must move over 3.35 TB/s and its
FLOPs over 67 TFLOP/s, the H100 SXM's HBM3 and float32 rates), before it the drivers' JSON records (phase 9's, phase 10's,
phase 11's, phase 12's and phase 13's: DOFs, steps, seconds per step,
Newton and Krylov iterations, errors; phases 10-13 with the card; phase
14's {"linemg", "distributed", "gloo_on_card"}; phase 15's
{"distributed_ablation": ...}; phase 16's {"scripts": ...}), then the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
no JAX.
"""

import concurrent.futures
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cmfem_tpu_torch  # noqa: E402
from cmfem_tpu_torch.core import (  # noqa: E402
    FESpace,
    make_cartesian_mesh_2d,
    make_cartesian_mesh_3d,
    make_tet_mesh,
    write_gmsh,
)
from cmfem_tpu_torch.entry import (  # noqa: E402
    BETA, DT, OPERATORS, PATHS, entry, mg_solve, operator_paths, spd_step,
    vc_entry,
)
from cmfem_tpu_torch.apps import (  # noqa: E402
    diffusion_mms, diffusion_mms_ale, elasticity, linear_cd_2d,
    linear_cd_2d_circle, linear_cd_transient, nonlinear_diffusion,
    qstar_blowing_1d,
)
from cmfem_tpu_torch.core import pointlocate  # noqa: E402
from cmfem_tpu_torch.kernels import bound, graph_ms, median_ms  # noqa: E402
from cmfem_tpu_torch.kernels import btdb as kbtdb  # noqa: E402
from cmfem_tpu_torch.kernels import build as kbuild  # noqa: E402
from cmfem_tpu_torch.kernels import linemg as klmg  # noqa: E402
from cmfem_tpu_torch.kernels import sumfact as ksum  # noqa: E402
from cmfem_tpu_torch.kernels import zchain as kz  # noqa: E402
from cmfem_tpu_torch.solvers.linemg import line_residual  # noqa: E402
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps  # noqa: E402
from cmfem_tpu_torch.ops.partial import (  # noqa: E402
    PAOperator, StructuredGrid3D, StructuredPAOperator)
from cmfem_tpu_torch.ops.sumfact import SumFactoredOperator  # noqa: E402
from cmfem_tpu_torch.scripts.common import disc_mesh  # noqa: E402,F401

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
F32 = torch.float32
# the launch counters each operator_paths path must move, and only they
PATH_COUNTERS = {
    "sumfact": set(), "sumfact-periodic": set(),
    "sumfact-fused": {"sumfact", "sumfact_fulld"},
    "sumfact-zfma-periodic": {"sumfact"},
    "sumfact-zchain": {"zchain"},
    "sumfact-zchain-periodic": {"zchain", "zchain_periodic"},
    "structured-pa": {"btdb"}, "pa": {"btdb"},
}


def log(msg):
    print(msg, flush=True)


def distort(v):
    """A smooth interior displacement fixing the unit cube's boundary:
    x + 0.03 prod_d (1 + x_d) sin(pi x_d) in every component."""
    return v + 0.03 * np.prod((1 + v) * np.sin(np.pi * v), axis=1,
                              keepdims=True)


def cdr(f):
    return (f.add_mass(1.0).add_convection(BETA, alpha=DT)
            .add_diffusion(0.1 * DT))


def vc(f, dim=3):
    """The variable-conductivity form: kappa = 0.1 + (last coordinate)^2."""
    return (f.add_mass(1.0).add_convection(BETA[:dim], alpha=DT)
            .add_diffusion(lambda x: DT * (0.1 + x[:, dim - 1] ** 2)))


def space_ops(mesh, order, device):
    return SpaceOps(FESpace(mesh, order), quad_order=2 * order, device=device)


def sumfact_operator(n, order, form, device, dtype, distorted=False):
    mesh = make_cartesian_mesh_3d(*n)
    if distorted:
        mesh = mesh.with_vertices(distort(mesh.vertices))
    ops = space_ops(mesh, order, device)
    data = form(BilinearForm(ops)).assemble()
    return SumFactoredOperator(ops, data, *n, order, device=device,
                               dtype=dtype)


def rel_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def compare(fk, fp, *args):
    """(max|k - p| / max|p|, max|k - p|) of one kernel and plain call."""
    yk = fk(*args)
    yp = fp(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(yk).all(), "kernel output is not finite"
    return rel_err(yk, yp), float((yk - yp).abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sumfact_flops(op):
    """FLOPs of one sum-factorized apply, counted as bench.py counts them:
    the pointwise D stage and 2 (p+1) FLOPs per output of each 1D
    contraction, forward and transposed."""
    p1, K = op.p + 1, op.Kz * op.Ky * op.Kx
    contr = 2 * p1 * (2 * op.Kx * op.NY * op.NZ + 4 * op.Kx * op.Ky * op.NZ
                      + 6 * K)
    return 2 * op.D.shape[0] * K + 2 * contr


def zchain_flops(op):
    """FLOPs of the z-chain alone: four z contractions in, the D stage,
    four transposed contractions out, each 2 (p+1) per quadrature point."""
    return (16 * (op.p + 1) + 2 * op.D.shape[0]) * op.Kz * op.Ky * op.Kx


def btdb_flops(BG, Dflat):
    """FLOPs of one B^T D B apply: two dense (m nq, nd) products and the
    m x m block per quadrature point, per element."""
    (mm, nq, ne), (mnq, nd) = Dflat.shape, BG.shape
    return ne * (4 * mnq * nd + 2 * mm * nq)


# the B1 shapes of earlier slices: hexes and quads at orders 1-4 with
# p + 1 points per axis
B1_EARLIER = {(4, 8, 8), (4, 27, 27), (4, 64, 64), (4, 125, 125),
              (3, 4, 4), (3, 9, 9), (3, 16, 16), (3, 25, 25)}


def time_new_btdb_shapes(dev, ne):
    """Each B1 shape of this slice (KERNEL_SHAPES less B1_EARLIER) on ``ne``
    elements of seeded float32 data: the kernel's and the plain version's
    device ms per call (graph_ms, in turns plain, kernel, kernel, plain),
    the bound and the error; {"m3 nd10 nq16": {...}, ...}."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    for m, nd, nq in sorted(set(kbtdb.KERNEL_SHAPES) - B1_EARLIER):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=F32)
        BG, u, D = rnd(m * nq, nd), rnd(nd, ne), rnd(m * m, nq, ne)
        packed = kbtdb.pack_bg(BG, m, nq)
        kfn = lambda: kbtdb.btdb_apply(BG, u, D, packed)
        pfn = lambda: kbtdb.btdb_plain(BG, u, D)
        err, abs_err = compare(lambda v: kbtdb.btdb_apply(BG, v, D, packed),
                               lambda v: kbtdb.btdb_plain(BG, v, D), u)
        assert err <= TOL[F32], (m, nd, nq, err)
        t = {"k": [], "p": []}
        for name in ("p", "k", "k", "p"):
            t[name].append(graph_ms(kfn if name == "k" else pfn, calls=2,
                                    reps=3))
        bnd = bound(nbytes(BG, u, D, u), btdb_flops(BG, D))
        rec = {"ne": ne, "ms": min(t["k"]), "plain_ms": min(t["p"]),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "max_abs_err": abs_err, "max_rel_err": err,
               "design": "tiled" if packed is not None else "per-element"}
        out[f"m{m} nd{nd} nq{nq}"] = rec
        log(f"phase 3: new shape (m, nd, nq) = ({m}, {nd}, {nq}), ne={ne}, "
            f"float32, {rec['design']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"{100 * bnd[0] / rec['ms']:.0f}% of bound; max|k-p|/max|p| "
            f"{err:.2e}")
        del BG, u, D, packed
    torch.cuda.empty_cache()
    return out


def stacked(fn):
    """fn's tuple of outputs as one tensor (for compare)."""
    return lambda *args: torch.stack(fn(*args))


def in_turns(kernel, plain, reps=50, graph=False):
    """Median ms of the kernel and the plain call, timed plain, kernel,
    kernel, plain: (kernel list, plain list).  With ``graph`` each is the
    device time per call of graph_ms, else one call between two events
    (host enqueue included)."""
    t = {"k": [], "p": []}
    for name in ("p", "k", "k", "p"):
        fn = kernel if name == "k" else plain
        t[name].append(graph_ms(fn) if graph else
                       median_ms(fn, reps=reps, warmup=min(10, reps)))
    return t["k"], t["p"]


def reset_counts():
    ksum.launches = ksum.launches_fulld = 0
    kbtdb.launches = kz.launches = kz.launches_periodic = 0
    klmg.launches_factor = klmg.launches_solve = 0


def counts():
    return {"sumfact": ksum.launches, "sumfact_fulld": ksum.launches_fulld,
            "btdb": kbtdb.launches,
            "zchain": kz.launches, "zchain_periodic": kz.launches_periodic,
            "line_factor": klmg.launches_factor,
            "line_solve": klmg.launches_solve}


def lane_kernel_resources(nvcc_log):
    """{"float N=5": (registers, spill bytes), ...} of the lane kernel's
    instantiations, from ptxas -v."""
    out = {}
    for name, res in kbuild.ptxas_resources(nvcc_log,
                                            "sumfact_lane_kernel").items():
        m = re.search(r"sumfact_lane_kernelI([fd])Li(\d)E", name)
        out[f"{'float' if m[1] == 'f' else 'double'} N={m[2]}"] = res
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel2(x, ref):
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref))


def check_step(step, u0, arrays, label, fn=None, floor_ok=False):
    """Run one counted step (through ``fn``, default the step's own apply);
    assert convergence and the explicit residual.  With ``floor_ok`` a
    GMRES that stopped on stagnation at the float32 floor counts as
    converged when its explicit residual is within 2e-6: the tolerance is
    clamped at 16 eps(float32) |MB| = 1.907e-6 |MB|, so two applies that
    round differently can end on either side of it.  Returns (result,
    seconds, launch counts)."""
    fn = step.fn if fn is None else fn
    reset_counts()
    res, secs = timed(lambda: step.solve(u0, fn, *arrays))
    launched = counts()
    A = step.apply_A(fn, *arrays)
    B = torch.where(step.mask, 0.0, u0)
    rel_pre = float(torch.linalg.vector_norm(step.M(B - A(res.x)))
                    / torch.linalg.vector_norm(step.M(B)))
    via = step.path if fn is step.fn else "the given apply"
    log(f"{label}: step {secs:.4f} s via {via}, cycles={res.iters} "
        f"arnoldi={res.inner_iters} converged={res.converged} "
        f"rel_residual={res.rel_residual:.3e}; explicit |M(B-Ax)|/|MB| = "
        f"{rel_pre:.3e}; launches {launched}")
    at_floor = floor_ok and res.stagnated and res.x.dtype == F32
    if at_floor and not res.converged:
        log(f"{label}: stopped at the float32 floor (16 eps = "
            f"{16 * torch.finfo(F32).eps:.4g}); explicit residual within 2e-6")
    assert (res.converged or at_floor) and torch.isfinite(res.x).all(), label
    assert rel_pre <= 2e-6, (label, rel_pre)
    return res, secs, launched


# relative L2 errors of the JAX driver (cmfem_tpu.apps.linear_cd_transient,
# float64 on a CPU) after 3 backward-Euler steps of dt = 1e-3 on the 9a mesh,
# Peclet 1, 10, 100: the level the port's errors are held to.  They are
# columns rel_l2_pe1..3 of the last row of out/error_history.csv after
#   python -c "from cmfem_tpu_torch.core.mesh import make_cartesian_mesh_2d,
#              write_gmsh; write_gmsh(make_cartesian_mesh_2d(64, 64),
#              'quads.msh')"
#   CMFEM_FORCE_CPU=1 python -m cmfem_tpu.apps.linear_cd_transient -i cfg.yaml
# with cfg.yaml holding mesh_file: quads.msh, serial_ref_levels: 2, order: 2,
# dt: 1.0e-3, t_final: 3.0e-3, save_paraview: false, output_path: out
# (about three minutes on a CPU).
JAX_9A_REL_L2 = (0.04190079046776633, 0.0451684941519411,
                 0.05610489416181405)


def read_csv(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def step_seconds(timing):
    """Median seconds per step of a driver's per-step timing records, and
    the share of it spent outside the solve (right-hand sides, error norms,
    CSV and VTU output)."""
    total = statistics.median(t["total"] for t in timing)
    solve = statistics.median(t["solve"] for t in timing)
    return total, 1.0 - solve / total


def run_drivers(device, tmp, n_cd=64, ref_cd=2, n_tri=32, steps=3,
                rel_l2_limit=None):
    """Phase 9: the four application drivers through ``run(cfg)``; returns
    the ``drivers`` record.  The sizes are arguments so that the control
    flow can be rehearsed small on a CPU."""
    mesh = lambda name, m: write_gmsh(m, os.path.join(tmp, name))
    quads = mesh("quads.msh", make_cartesian_mesh_2d(n_cd, n_cd))
    tris = mesh("tris.msh", make_cartesian_mesh_2d(n_tri, n_tri,
                                                   geom="triangle"))
    disc = mesh("disc.msh", disc_mesh(n_tri))
    out = lambda name: os.path.join(tmp, name)
    records = []

    # -- 9a. linear_cd_transient: host loop, scan_stepping, one SDIRK2 step
    cfg = {"mesh_file": quads, "serial_ref_levels": ref_cd, "order": 2,
           "dt": 1e-3, "t_final": steps * 1e-3, "save_paraview": False}
    runs = {}
    for name, extra in (("host", {}), ("scan", {"scan_stepping": True}),
                        ("sdirk2", {"time_integrator": "sdirk2",
                                    "t_final": 1e-3})):
        reset_counts()
        r, secs = timed(lambda: linear_cd_transient.run(
            {**cfg, **extra, "output_path": out(f"cd_{name}")},
            device=device))
        assert not any(counts().values()), counts()
        assert r["converged"], f"9a {name}: a GMRES solve did not converge"
        assert np.isfinite(r["c"]).all()
        per_step, other = step_seconds(r["timing"])
        nsteps = len(r["timing"])
        rel = [r["final_errors"][k] for k in (3, 5, 7)]
        log(f"phase 9a: linear_cd_transient {name}: {r['fes'].nscalar} DOFs "
            f"x 3 Peclet cases, {nsteps} steps, run {secs:.2f} s, median "
            f"{per_step:.4f} s/step ({other:.1%} outside the solves), "
            f"Arnoldi steps per step {sum(r['arnoldi']) / nsteps:.0f} "
            f"(all converged), final rel L2 {rel}")
        assert all(np.isfinite(rel)) and all(v > 0 for v in rel), rel
        runs[name] = r
        records.append({
            "driver": "linear_cd_transient", "variant": name,
            "dofs": r["fes"].nscalar, "steps": nsteps, "run_s": secs,
            "s_per_step": per_step, "share_outside_solve": other,
            "krylov_iters_per_step": sum(r["arnoldi"]) / nsteps,
            "rel_l2": rel})
    _, v_host = read_csv(os.path.join(out("cd_host"), "error_history.csv"))
    _, v_scan = read_csv(os.path.join(out("cd_scan"), "error_history.csv"))
    d_csv = float(np.abs(v_host - v_scan).max())
    log(f"phase 9a: host loop vs scan_stepping CSV max|d| = {d_csv:.3e} "
        f"(tol 1e-10), solutions max|d| = "
        f"{np.abs(runs['host']['c'] - runs['scan']['c']).max():.3e}")
    assert v_host.shape == v_scan.shape == (steps + 1, 8)
    assert d_csv <= 1e-10, d_csv
    if rel_l2_limit is not None:
        rel = [runs["host"]["final_errors"][k] for k in (3, 5, 7)]
        log(f"phase 9a: rel L2 {rel} against the JAX driver's "
            f"{rel_l2_limit} on this mesh (x 1.001)")
        assert all(a <= 1.001 * b for a, b in zip(rel, rel_l2_limit)), rel

    # -- 9b. diffusion_mms on triangles: Jacobi-CG and GeometricMG-CG
    cfg = {"mesh_file": tris, "serial_ref_levels": 1, "order": 2,
           "dt": 1e-2, "t_final": 3e-2}
    mms = {}
    for solver in ("jacobi", "mg"):
        pointlocate.last_locator = None
        reset_counts()
        r, secs = timed(lambda: diffusion_mms.run(
            {**cfg, "linear_solver": solver, "output_path": out(f"mms_{solver}"),
             "save_paraview": solver == "jacobi", "paraview_every": 3},
            device=device))
        assert not any(counts().values()), counts()
        assert r["converged"], f"9b {solver}: a CG solve did not converge"
        per_step, other = step_seconds(r["timing"])
        log(f"phase 9b: diffusion_mms linear_solver={solver}: "
            f"{r['fes'].nscalar} DOFs, {len(r['timing'])} steps, run "
            f"{secs:.2f} s, median {per_step:.4f} s/step ({other:.1%} outside "
            f"the solve), CG iterations per step {r['solve_iters']}, final "
            f"L2 {r['final_l2']:.6e} Linf {r['final_linf']:.6e}"
            + (f"; point locator: {pointlocate.last_locator}"
               if solver == "mg" else ""))
        mms[solver] = r
        records.append({
            "driver": "diffusion_mms", "variant": solver,
            "dofs": r["fes"].nscalar, "steps": len(r["timing"]),
            "run_s": secs, "s_per_step": per_step,
            "share_outside_solve": other,
            "krylov_iters_per_step": r["solve_iters"],
            "l2": r["final_l2"], "linf": r["final_linf"],
            "point_locator": pointlocate.last_locator})
    assert pointlocate.last_locator in ("native", "numpy")
    vtus = [f for _, _, fs in os.walk(out("mms_jacobi")) for f in fs
            if f.endswith((".vtu", ".pvd"))]
    assert len(vtus) >= 3, vtus  # steps 0 and 3 and the PVD index
    d_l2 = abs(mms["mg"]["final_l2"] - mms["jacobi"]["final_l2"])
    log(f"phase 9b: MG vs Jacobi final L2 |d| = {d_l2:.3e} (tol 1e-8), "
        f"solutions max|d| = "
        f"{np.abs(mms['mg']['u'] - mms['jacobi']['u']).max():.3e}; "
        f"{len(vtus)} VTU/PVD files written")
    assert d_l2 <= 1e-8 and 0 < mms["mg"]["final_l2"] < 1e-4, d_l2
    assert max(mms["mg"]["solve_iters"]) < min(mms["jacobi"]["solve_iters"])

    # -- 9c. the steady drivers
    for app, name, cfg in (
            (linear_cd_2d, "linear_cd_2d", {"mesh_file": quads, "order": 3}),
            (linear_cd_2d_circle, "linear_cd_2d_circle",
             {"mesh_file": disc, "serial_ref_levels": 1, "order": 2})):
        reset_counts()
        r, secs = timed(lambda: app.run(
            {**cfg, "output_path": out(name), "save_paraview": False},
            device=device))
        assert not any(counts().values()), counts()
        res = r["solve"]
        log(f"phase 9c: {name}: {r['fes'].nscalar} DOFs, run {secs:.2f} s, "
            f"GMRES {r['solve_seconds']:.3f} s, cycles={res.iters} "
            f"arnoldi={res.inner_iters} converged={res.converged} "
            f"rel_residual={res.rel_residual:.3e}; rel L2 {r['rel_l2']:.6e}")
        assert res.converged and np.isfinite(r["u"]).all()
        assert 0 < r["rel_l2"] < 1e-2, r["rel_l2"]
        records.append({
            "driver": name, "dofs": r["fes"].nscalar, "steps": 1,
            "run_s": secs, "s_per_step": r["solve_seconds"],
            "krylov_iters_per_step": res.inner_iters,
            "abs_l2": r["abs_l2"], "rel_l2": r["rel_l2"]})
    return records


# figures of the JAX drivers (float64 on a CPU) on phase 10's
# configurations, the level the port is held to.  From, in a scratch
# directory with PYTHONPATH at the repo and CMFEM_FORCE_CPU=1:
#   python -c "from cmfem_tpu_torch.core.mesh import make_cartesian_mesh_2d,
#              write_gmsh; write_gmsh(make_cartesian_mesh_2d(128, 128,
#              sx=0.01, sy=0.01), 'square_0p01.msh');
#              write_gmsh(make_cartesian_mesh_2d(64, 64, geom='triangle'),
#              'tris.msh')"
#   python -m cmfem_tpu.apps.nonlinear_diffusion -i nl.yaml
#   python -m cmfem_tpu.apps.diffusion_mms_ale -i ale.yaml
#   python -m cmfem_tpu.apps.qstar_blowing_1d --num-elements 512 --quiet
#          --output-dir out_q
# nl.yaml: mesh_file: square_0p01.msh, order: 2, dt: 0.1, t_final: 0.2,
# L: 0.01, series_terms: 400, save_paraview: false, newton_print_level: 0,
# output_path: out_nl (10a: the last row's rel_l2 and the newton_iters
# column of error_history_nonlinear_1D.csv; about a minute and a half);
# ale.yaml: mesh_file: tris.msh, serial_ref_levels: 1, order: 1,
# alpha: 0.1, dt: 0.05, t_final: 0.15, ale_map: accuracy_a,
# save_paraview: false, output_path: out_ale (10c: the last row's l2_error
# of error_history.csv); 10d: sdot_numerical_m_s of
# out_q/qstar_blowing_summary.csv and the printed Newton iterations.
JAX_10A_REL_L2 = 0.003061296905842773
JAX_10A_NEWTON = [4, 4]
JAX_10C_L2 = 0.005247881677260601
JAX_10D_SDOT = 3.9971577446211632e-04
JAX_10D_ITERS = 3


def run_nonlinear_drivers(device, tmp, n_nl=128, n_ale=64, n_q=512,
                          beam3d=(40, 4, 4), steps=3, steps_nl=2, refs=True):
    """Phase 10: the slice-7 drivers through ``run(cfg)`` (``run(p)`` for
    Q*), float64; returns the ``nonlinear_drivers`` record.  The sizes are
    arguments so that the control flow can be rehearsed small on a CPU;
    ``refs`` holds the results to the JAX drivers' figures above, which
    belong to the default sizes only."""
    mesh = lambda name, m: write_gmsh(m, os.path.join(tmp, name))
    out = lambda name: os.path.join(tmp, name)
    records = []

    # -- 10a. nonlinear_diffusion: BE + Newton, AD JVP and element Jacobians
    sq = mesh("square_0p01.msh", make_cartesian_mesh_2d(n_nl, n_nl, sx=0.01,
                                                         sy=0.01))
    cfg = {"mesh_file": sq, "order": 2, "dt": 0.1, "t_final": steps_nl * 0.1,
           "L": 0.01, "series_terms": 400, "save_paraview": False,
           "newton_print_level": 0, "output_path": out("nl")}
    reset_counts()
    r, secs = timed(lambda: nonlinear_diffusion.run(cfg, device=device))
    assert not any(counts().values()), counts()
    assert r["converged"] and np.isfinite(r["u"]).all()
    per_step, other = step_seconds(r["timing"])
    rel = r["final"][1]
    newton = r["newton_iters"]
    gmres_per_step = [sum(k) for k in r["krylov_iters"]]
    split = {k: statistics.median(t[k] for t in r["timing"])
             for k in ("residual", "jacobian", "linear")}
    log(f"phase 10a: nonlinear_diffusion: {r['fes'].nscalar} DOFs, "
        f"{len(newton)} steps, run {secs:.2f} s, median {per_step:.4f} "
        f"s/step ({other:.1%} outside the Newton solves; in them, median "
        f"s/step: residuals {split['residual']:.4f}, Jacobian diagonals "
        f"and linearize traces {split['jacobian']:.4f}, GMRES "
        f"{split['linear']:.4f}), Newton "
        f"iterations {newton}, GMRES iterations per step {gmres_per_step}, "
        f"final rel L2 {rel:.10e}")
    assert 0 < rel < 2e-2, rel
    if refs:
        d = abs(rel / JAX_10A_REL_L2 - 1.0)
        log(f"phase 10a: rel L2 vs the JAX driver's {JAX_10A_REL_L2!r}: "
            f"relative difference {d:.3e} (tol 1e-6); Newton iterations "
            f"{newton} vs {JAX_10A_NEWTON}")
        assert d <= 1e-6 and newton == JAX_10A_NEWTON, (d, newton)
    records.append({
        "driver": "nonlinear_diffusion", "dofs": r["fes"].nscalar,
        "steps": len(newton), "run_s": secs, "s_per_step": per_step,
        "share_outside_solve": other, "newton_iters_per_step": newton,
        "krylov_iters_per_step": gmres_per_step, "newton_split_s": split,
        "rel_l2": rel})

    # -- 10b. elasticity: the 2D default and a 3D cantilever, Jacobi-CG
    E, nu, L, H, traction = 1.0e6, 0.3, 1.0, 0.1, -100.0
    for dim, extra in ((2, {}), (3, dict(zip(("nx", "ny", "nz"), beam3d)))):
        reset_counts()
        r, secs = timed(lambda: elasticity.run(
            {"dim": dim, "save_paraview": False,
             "output_path": out(f"elast{dim}"), **extra}, device=device))
        assert not any(counts().values()), counts()
        res = r["solve"]
        # Euler-Bernoulli: plane strain in 2D (E' = E / (1 - nu^2), load per
        # unit thickness traction H); in 3D E, I = H^4 / 12, load traction H^2
        if dim == 2:
            beam = traction * H * L**3 / (3 * E / (1 - nu**2) * H**3 / 12)
        else:
            beam = traction * H * H * L**3 / (3 * E * H**4 / 12)
        ratio = r["tip_deflection"] / beam
        dofs = r["fes"].nscalar * dim
        per_step, other = step_seconds(r["timing"])
        shape = " x ".join(map(str, beam3d if dim == 3 else (40, 4)))
        log(f"phase 10b: elasticity {dim}D {shape} order 2: {dofs} DOFs, run "
            f"{secs:.2f} s, CG {r['timing'][0]['solve']:.3f} s ({other:.1%} "
            f"of the run outside it), iterations {r['iters']} "
            f"(solver_maxiter 5000), converged="
            f"{res.converged} stagnated={res.stagnated} rel_residual="
            f"{res.rel_residual:.3e}; tip deflection {r['tip_deflection']:.6e}"
            f", Euler-Bernoulli {beam:.6e}, ratio {ratio:.5f} (within 8%)")
        # converged, or stopped at the float64 floor within 10 x rtol 1e-10
        assert res.converged or (res.stagnated and res.rel_residual <= 1e-9)
        assert r["iters"] < 5000 and abs(ratio - 1.0) <= 0.08, ratio
        records.append({
            "driver": "elasticity", "variant": f"{dim}D {shape}",
            "dofs": dofs, "steps": 1, "run_s": secs, "s_per_step": per_step,
            "share_outside_solve": other, "krylov_iters_per_step": r["iters"],
            "rel_residual": res.rel_residual,
            "tip_deflection": r["tip_deflection"], "beam_ratio": ratio})

    # -- 10c. diffusion_mms_ale: accuracy_a and identity (= diffusion_mms)
    tris = mesh("tris_ale.msh", make_cartesian_mesh_2d(n_ale, n_ale,
                                                       geom="triangle"))
    base = {"mesh_file": tris, "serial_ref_levels": 1, "order": 1,
            "alpha": 0.1, "dt": 0.05, "t_final": steps * 0.05,
            "save_paraview": False}
    ale = {}
    for kind in ("accuracy_a", "identity"):
        reset_counts()
        r, secs = timed(lambda: diffusion_mms_ale.run(
            {**base, "ale_map": kind, "output_path": out(f"ale_{kind}")},
            device=device))
        assert not any(counts().values()), counts()
        assert r["converged"] and np.isfinite(r["u"]).all()
        per_step, other = step_seconds(r["timing"])
        log(f"phase 10c: diffusion_mms_ale {kind}: {r['fes'].nscalar} DOFs, "
            f"{len(r['timing'])} steps, run {secs:.2f} s, median "
            f"{per_step:.4f} s/step ({other:.1%} outside the solves), GMRES "
            f"iterations per step {r['krylov_iters']}, final L2 "
            f"{r['final_l2']:.10e} Linf {r['final_linf']:.6e}")
        ale[kind] = r
        records.append({
            "driver": "diffusion_mms_ale", "variant": kind,
            "dofs": r["fes"].nscalar, "steps": len(r["timing"]),
            "run_s": secs, "s_per_step": per_step,
            "share_outside_solve": other,
            "krylov_iters_per_step": r["krylov_iters"],
            "l2": r["final_l2"], "linf": r["final_linf"]})
    reset_counts()
    static = diffusion_mms.run({**base, "output_path": out("ale_static")},
                               device=device)
    assert not any(counts().values()), counts()
    d_id = float(np.abs(ale["identity"]["u"] - static["u"]).max())
    l2a = ale["accuracy_a"]["final_l2"]
    log(f"phase 10c: identity map vs diffusion_mms max|d| = {d_id:.3e} "
        f"(tol 1e-8); accuracy_a L2 {l2a:.10e} (< 2e-2)")
    assert d_id <= 1e-8 and 0 < l2a < 2e-2, (d_id, l2a)
    if refs:
        d = abs(l2a / JAX_10C_L2 - 1.0)
        log(f"phase 10c: accuracy_a L2 vs the JAX driver's {JAX_10C_L2!r}: "
            f"relative difference {d:.3e} (tol 1e-6)")
        assert d <= 1e-6, d

    # -- 10d. qstar_blowing_1d: jacfwd Jacobian, dense solves
    reset_counts()
    r, secs = timed(lambda: qstar_blowing_1d.run(qstar_blowing_1d.QstarParams(
        num_elements=n_q, verbose=False, output_dir=out("qstar")),
        device=device))
    assert not any(counts().values()), counts()
    log(f"phase 10d: qstar_blowing_1d N={n_q}: run {secs:.3f} s, Newton "
        f"iterations {r['iterations']}, converged={r['converged']}, sdot "
        f"{r['sdot']!r}, rel error vs table {r['sdot_rel_error']:.6e}")
    assert r["converged"] and abs(r["sdot_rel_error"]) < 5e-3
    if refs:
        d = abs(r["sdot"] / JAX_10D_SDOT - 1.0)
        log(f"phase 10d: sdot vs the JAX driver's {JAX_10D_SDOT!r}: relative "
            f"difference {d:.3e} (tol 1e-10); Newton iterations "
            f"{r['iterations']} vs {JAX_10D_ITERS}")
        assert d <= 1e-10 and r["iterations"] == JAX_10D_ITERS, d
    records.append({
        "driver": "qstar_blowing_1d", "dofs": n_q, "steps": 1, "run_s": secs,
        "s_per_step": r["timing"][0]["solve"], "share_outside_solve": 0.0,
        "newton_iters_per_step": r["iterations"],
        "sdot": r["sdot"], "sdot_rel_error": r["sdot_rel_error"]})
    return records


# figures of the JAX driver (cmfem_tpu.apps.ablation_case1, float64 on a
# CPU) on phase 11's strip and deck after 6 steps of dt 0.1: the last rows
# of out_c1/temperature_probes.csv (TC1..TC7) and out_c1/mass_metrics.csv
# (m_dot_g_surf, front_98_virgin, front_2_char) and the linear solves per
# step (rows per step of the Newton CSV, less one), from, in a scratch
# directory with PYTHONPATH at the repo and CMFEM_FORCE_CPU=1:
#   python -c "from cmfem_tpu_torch.core.mesh import make_strip_mesh_2d,
#              write_gmsh; write_gmsh(make_strip_mesh_2d(11, 239),
#              'strip.msh')"
#   python -m cmfem_tpu.apps.ablation_case1 -i case1.yaml
# case1.yaml: mesh_file: strip.msh, material_file: <the repo's
# tests/fixtures/tacot_synthetic.json>, order: 1, dt: 0.1, t_final: 0.6,
# bdr_attr_top: 3, probe_x: 0.00125, newton_print_level: 0, save_paraview:
# false, output_path: out_c1 (about 40 s).
JAX_11A_PROBES = (929.5044206028347, 497.0586608917528, 309.3516108187271,
                  300.006183837962, 300.0014071351998, 300.0014057685885,
                  300.0014051202585)
JAX_11A_MDOT = 0.04970705517568322
JAX_11A_FRONTS = (0.001245085082024963, 0.0)
JAX_11A_NEWTON = [4, 3, 3, 3, 3, 3]
TACOT_DECK = os.path.join(ROOT, "tests", "fixtures", "tacot_synthetic.json")


def csv_agree(path_a, path_b, rtol, floors=None):
    """max over the CSV's values of |a - b| / (rtol |b| + 1e-12 max|b| of
    the column): <= 1 when they agree to ``rtol`` (the floor takes the
    roundoff of values that are zero in one run, as the t = 0 mass flux;
    ``floors`` {column: factor} replaces 1e-12 for some columns).  NaN
    must sit in the same places."""
    _, a = read_csv(path_a)
    _, b = read_csv(path_b)
    assert a.shape == b.shape, (path_a, a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b)), path_a
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    factor = np.full(b.shape[1], 1e-12)
    for j, f in (floors or {}).items():
        factor[j] = f
    floor = factor * np.abs(b).max(axis=0)
    return float(np.max(np.abs(a - b) / (rtol * np.abs(b) + floor + 1e-300)))


def first_step_rows(out_dir, r):
    """A run's output rows at its first step (t = 0.1; phase 15a holds the
    distributed drivers to them): the probe temperatures (wall column
    included), the pressure probes where the driver writes them, m_dot_g,
    the linear solves of step 1."""
    _, probes = read_csv(os.path.join(out_dir, "temperature_probes.csv"))
    _, mass = read_csv(os.path.join(out_dir, "mass_metrics.csv"))
    press = os.path.join(out_dir, "pressure_probes.csv")
    return {"t": float(probes[1, 0]),
            "T": [float(v) for v in probes[1, 1:]],
            "p": ([float(v) for v in read_csv(press)[1][1, 1:]]
                  if os.path.exists(press) else None),
            "m_dot_g": float(mass[1, 1]), "newton": r["newton_iters"][0]}


def split_median(timing, keys=("residual", "jacobian", "factorization",
                               "linear", "update", "state", "output")):
    return {k: statistics.median(t.get(k, 0.0) for t in timing) for k in keys}


def run_ablation_case1(device, tmp, nx=11, ny=239, steps=6, ref_levels=2,
                       ref_steps=2, refs=True):
    """Phase 11: the case-1 ablation driver through ``run(cfg)`` on the
    graded TACOT strip (``make_strip_mesh_2d``) with the synthetic deck,
    float64; returns the ``ablation_case1`` record.  The sizes are arguments
    so that the control flow can be rehearsed small on a CPU; ``refs``
    holds (a) to the JAX driver's figures above, which belong to the default
    sizes only."""
    from cmfem_tpu_torch.apps import ablation_case1
    from cmfem_tpu_torch.apps.common import make_block_linear_solver
    from cmfem_tpu_torch.core import make_strip_mesh_2d

    strip = write_gmsh(make_strip_mesh_2d(nx, ny), os.path.join(tmp,
                                                                "strip.msh"))
    out = lambda name: os.path.join(tmp, name)
    base = {"mesh_file": strip, "material_file": TACOT_DECK, "order": 1,
            "dt": 0.1, "t_final": steps * 0.1, "bdr_attr_top": 3,
            "probe_x": 0.00125, "newton_print_level": 0,
            "save_paraview": False, "output_every": 5}
    records = []

    def drive(label, cfg):
        reset_counts()
        r, secs = timed(lambda: ablation_case1.run(cfg, device=device))
        assert not any(counts().values()), counts()
        assert r["converged"] and np.isfinite(r["T"]).all()
        per_step = statistics.median(t["total"] for t in r["timing"])
        split = split_median(r["timing"])
        log(f"phase 11{label}: {2 * r['fes'].nscalar} DOFs, "
            f"{len(r['timing'])} steps, run {secs:.2f} s, median "
            f"{per_step:.4f} s/step; Newton split (median s/step): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; linear solves per step {r['newton_iters']}"
            + (f", Krylov iterations per solve {r['krylov_iters']}"
               if "krylov_iters" in r else ""))
        return r, secs, per_step, split

    # -- 11a. the eager path: AD Jacobians on the card, host splu
    ra, secs, per_step, split = drive(
        "a host LU", {**base, "output_path": out("c1_lu")})
    _, probes = read_csv(os.path.join(out("c1_lu"), "temperature_probes.csv"))
    _, mass = read_csv(os.path.join(out("c1_lu"), "mass_metrics.csv"))
    final = {"probes": [float(v) for v in probes[-1, 2:]],
             "m_dot_g": float(mass[-1, 1]),
             "fronts": [float(mass[-1, 3]), float(mass[-1, 4])]}
    log(f"phase 11a: t = {probes[-1, 0]:.3f}: probes {final['probes']}, "
        f"m_dot_g {final['m_dot_g']!r}, fronts 98%/2% {final['fronts']}")
    if refs:
        got = final["probes"] + [final["m_dot_g"]] + final["fronts"]
        ref = list(JAX_11A_PROBES) + [JAX_11A_MDOT] + list(JAX_11A_FRONTS)
        d = max(abs(a - b) / abs(b) if b else abs(a)
                for a, b in zip(got, ref))
        log(f"phase 11a: vs the JAX driver's figures: max relative "
            f"difference {d:.3e} (tol 1e-7); linear solves per step "
            f"{ra['newton_iters']} vs {JAX_11A_NEWTON}")
        assert d <= 1e-7 and ra["newton_iters"] == JAX_11A_NEWTON, d
    records.append({
        "driver": "ablation_case1", "variant": "host LU (splu)",
        "dofs": 2 * ra["fes"].nscalar, "steps": len(ra["timing"]),
        "run_s": secs, "s_per_step": per_step, "newton_split_s": split,
        "newton_iters_per_step": ra["newton_iters"], **final,
        "first_step": first_step_rows(out("c1_lu"), ra)})

    # -- 11b. scan_stepping: the block-QR direct solver on the card
    rb, secs, per_step, split = drive(
        "b scan_stepping", {**base, "scan_stepping": True,
                            "output_path": out("c1_scan")})
    d_csv = max(csv_agree(os.path.join(out("c1_scan"), name),
                          os.path.join(out("c1_lu"), name), 1e-8)
                for name in ("temperature_probes.csv", "mass_metrics.csv"))
    log(f"phase 11b: linear solver {rb['linear_solver']}; CSVs vs 11a: "
        f"max |d| / (1e-8 |a| + floor) = {d_csv:.3f} (<= 1)")
    assert rb["linear_solver"] == "BlockTridiagDirect"
    assert d_csv <= 1.0 and rb["newton_iters"] == ra["newton_iters"], d_csv
    records.append({
        "driver": "ablation_case1", "variant": "scan_stepping (block QR)",
        "dofs": 2 * rb["fes"].nscalar, "steps": len(rb["timing"]),
        "run_s": secs, "s_per_step": per_step, "newton_split_s": split,
        "newton_iters_per_step": rb["newton_iters"],
        "krylov_iters_per_solve": rb["krylov_iters"],
        "csv_vs_host_lu": d_csv})

    # -- 11c. linear_solver: gmres on the first Newton system of step 1, at
    # linear_rtol 1e-12: at the driver's 1e-10 the preconditioned residual
    # leaves ~4e-5 of the LU direction in this ill-conditioned system (CPU,
    # same system), at 1e-12 ~6e-9
    reset_counts()
    cfg = {**base, "linear_solver": "gmres", "linear_rtol": 1e-12,
           "output_path": out("c1_gm")}
    c = ablation_case1.Case1(cfg, device, torch.float64)
    T, p = c.initial_fields()
    X = c.initial_state().extent
    To, po = c.ops.values_at_qp(T), c.ops.values_at_qp(p)
    T, p = c.enforce_bc(T, p, ablation_case1.evaluate_schedule(c.schedule,
                                                               c.dt))
    R = c.residual(T, p, To, po, X, c.dt)
    blocks = c.sys.element_jacobians(T, p, To, po, X, c.dt)
    d_lu = c.host_lu(blocks).solve(-R)
    factory = make_block_linear_solver(cfg, c.fes.element_dofs, c.n, c.ess,
                                       c.ess, node_positions=c.fes.node_positions,
                                       device=device)
    d_gm, gm_s = timed(lambda: factory(blocks).solve(-R))
    res = factory.results[-1]
    c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
              + ("newton", "total")}, 0.0)
    assert not any(counts().values()), counts()
    d_dir = rel2(d_gm, d_lu)
    log(f"phase 11c: point-block GMRES(400), rtol 1e-12, on the first Newton "
        f"system of step 1: converged={res.converged}, {res.inner_iters} inner "
        f"iterations ({res.iters} cycles; JAX records 299-358 at refine 0 "
        f"on the reference deck), {gm_s:.3f} s ({1e3 * gm_s / max(1, res.inner_iters):.2f} "
        f"ms per iteration); direction vs the host LU's, 2-norm rel "
        f"{d_dir:.3e} (tol 1e-8)")
    assert res.converged and d_dir <= 1e-8, d_dir
    records.append({
        "driver": "ablation_case1",
        "variant": "gmres (rtol 1e-12), one Newton system",
        "dofs": 2 * c.n, "krylov_iters": res.inner_iters,
        "restart_cycles": res.iters, "solve_s": gm_s,
        "direction_vs_lu": d_dir})
    del c, blocks, factory, R, d_lu, d_gm

    # -- 11d. the strip refined twice through scan_stepping
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rd, secs, per_step, split = drive(
        "d refined", {**base, "serial_ref_levels": ref_levels,
                      "t_final": ref_steps * 0.1, "scan_stepping": True,
                      "output_path": out("c1_ref")})
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else float("nan"))
    solves = sum(rd["newton_iters"])
    fac_ms = 1e3 * sum(t["factorization"] for t in rd["timing"]) / solves
    sol_ms = 1e3 * sum(t["linear"] for t in rd["timing"]) / solves
    jac_ms = 1e3 * sum(t["jacobian"] for t in rd["timing"]) / solves
    res_ms = ablation_residual_in_turns(device, rd)
    log(f"phase 11d: per Newton solve: element Jacobians {jac_ms:.1f} ms, "
        f"block-QR factorization {fac_ms:.1f} ms, banded solve with its "
        f"GMRES {sol_ms:.1f} ms; peak device memory {peak:.3f} GiB; "
        f"residual ms (CUDA events, generic, lattice, lattice, generic): "
        f"{res_ms}")
    records.append({
        "driver": "ablation_case1", "variant": "scan_stepping, refined x2",
        "dofs": 2 * rd["fes"].nscalar, "steps": len(rd["timing"]),
        "run_s": secs, "s_per_step": per_step, "newton_split_s": split,
        "newton_iters_per_step": rd["newton_iters"],
        "krylov_iters_per_solve": rd["krylov_iters"],
        "jacobian_ms_per_solve": jac_ms, "factorization_ms_per_call": fac_ms,
        "solve_ms_per_call": sol_ms, "peak_mem_gib": peak,
        "residual_ms": res_ms})
    return records


# figures of the JAX driver (cmfem_tpu.apps.ablation_case2_1, float64 on a
# CPU) on phase 12's strip, deck and schedule after 6 steps of dt 0.1: the
# rows at t = 0.4 (the last blowing step) and t = 0.6 of
# out_c21/temperature_probes.csv (wall, TC1..TC8), out_c21/mass_metrics.csv
# (m_dot_g_surf, front_98_virgin, front_2_char) and
# out_c21/boundary_diagnostics.csv (BprimeG_surf, q_conv_surf, q_surf), and
# the linear solves per step, from the strip.msh of phase 11's command and
#   python -m cmfem_tpu.apps.ablation_case2_1 -i case21.yaml
# case21.yaml: case1.yaml's keys with t_final: 0.6, output_path: out_c21 and
# boundary_conditions_file: <the repo's tests/fixtures/surface_bc_case21.dat>
# (about a minute).
JAX_12A = {
    0.4: {"probes": [797.692897543996, 439.6375101003896, 327.6962934252517,
                     300.6278392746127, 300.0001259954527, 300.0000093195238,
                     300.0000092930709, 300.0000092690917,
                     300.0000092403372],
          "m_dot_g_surf": 0.001694075398190448,
          "BprimeG_surf": 0.005662891762122673,
          "q_conv_surf": 276004.9720749615, "q_surf": 255902.0255563865,
          "fronts": [0.0, 0.0]},
    0.6: {"probes": [580.3375977629103, 468.78946739739, 353.1402586345304,
                     302.3403174893603, 300.0010860664635, 300.0000045096729,
                     300.0000043089792, 300.0000043261628,
                     300.0000043469352],
          "m_dot_g_surf": 0.0003359999232541448, "BprimeG_surf": 0.0,
          "q_conv_surf": -2803.375977629107, "q_surf": -7880.026329006657,
          "fronts": [0.0, 0.0]}}
JAX_12A_NEWTON = [3, 3, 3, 3, 3, 3]
SCHEDULE_C21 = os.path.join(ROOT, "tests", "fixtures", "surface_bc_case21.dat")
C21_ROW_KEYS = ("probes", "m_dot_g_surf", "BprimeG_surf", "q_conv_surf",
                "q_surf", "fronts")


def case21_rows(out_dir):
    """{t: {probes, m_dot_g_surf, BprimeG_surf, q_conv_surf, q_surf,
    fronts}} of a case-2.1 run's output rows at t = 0.4 and the last t."""
    _, probes = read_csv(os.path.join(out_dir, "temperature_probes.csv"))
    _, mass = read_csv(os.path.join(out_dir, "mass_metrics.csv"))
    hdr, bdr = read_csv(os.path.join(out_dir, "boundary_diagnostics.csv"))
    col = {k: hdr.index(k) for k in ("BprimeG_surf", "q_conv_surf",
                                     "q_surf")}
    rows = {}
    for i in sorted({int(np.argmin(np.abs(probes[:, 0] - 0.4))),
                     len(probes) - 1}):
        rows[round(float(probes[i, 0]), 6)] = {
            "probes": [float(v) for v in probes[i, 1:]],
            "m_dot_g_surf": float(mass[i, 1]),
            **{k: float(bdr[i, j]) for k, j in col.items()},
            "fronts": [float(mass[i, 3]), float(mass[i, 4])]}
    return rows


def rows_rel_diff(got, ref, keys=C21_ROW_KEYS):
    """max relative difference of two ``case21_rows`` (or
    ``case22_rows``) (absolute where the reference value is 0)."""
    d = 0.0
    for t, r in ref.items():
        for k in keys:
            a, b = np.atleast_1d(got[t][k]), np.atleast_1d(r[k])
            d = max(d, float(np.max(np.where(
                b != 0, np.abs(a - b) / np.where(b != 0, np.abs(b), 1.0),
                np.abs(a)))))
    return d


def ms_per_call(device, fn, reps=5, warmup=2):
    """Median ms of one call between CUDA events (host clock on a CPU)."""
    if torch.device(device).type == "cuda":
        return median_ms(fn, reps=reps, warmup=warmup)
    return 1e3 * timed(fn)[1]


def run_ablation_case21(device, tmp, nx=11, ny=239, steps=6, refs=True):
    """Phase 12: the case-2.1 ablation driver through ``run(cfg)`` on phase
    11's strip with the synthetic deck and B' table and the schedule
    fixture (steps 1-4 on the chemistry-blowing branch, step 4 on the 0.4 s
    node, 5-6 cooling), float64; returns the ``ablation_case2_1`` records.
    The sizes are arguments so that the control flow can be rehearsed small
    on a CPU; ``refs`` holds (a) to the JAX driver's figures above, which
    belong to the default sizes only."""
    from cmfem_tpu_torch.apps import ablation_case2_1
    from cmfem_tpu_torch.core import make_strip_mesh_2d

    strip = write_gmsh(make_strip_mesh_2d(nx, ny), os.path.join(tmp,
                                                                "strip.msh"))
    out = lambda name: os.path.join(tmp, name)
    base = {"mesh_file": strip, "material_file": TACOT_DECK,
            "boundary_conditions_file": SCHEDULE_C21, "order": 1, "dt": 0.1,
            "t_final": steps * 0.1, "bdr_attr_top": 3, "probe_x": 0.00125,
            "newton_print_level": 0, "save_paraview": False,
            "output_every": 3}
    records = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def drive(label, cfg):
        reset_counts()
        r, secs = timed(lambda: ablation_case2_1.run(cfg, device=device))
        assert not any(counts().values()), counts()
        assert r["converged"] and np.isfinite(r["T"]).all()
        per_step = statistics.median(t["total"] for t in r["timing"])
        split = split_median(r["timing"])
        log(f"phase 12{label}: {2 * r['fes'].nscalar} DOFs, "
            f"{len(r['timing'])} steps, run {secs:.2f} s, median "
            f"{per_step:.4f} s/step; Newton split (median s/step): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; linear solves per step {r['newton_iters']}")
        return r, secs, per_step, split

    # -- 12a. the eager path: host splu over the element and face blocks,
    # jacobian_check at step 1 and once per flux branch, a checkpoint at
    # t = 0.3
    ra, secs, per_step, split = drive("a host LU", {
        **base, "jacobian_check": True, "output_path": out("c21_lu"),
        "restart_write_file": out("c21.chk"), "restart_write_at_time": 0.3,
        "restart_write_at_end": False})
    jc = ra["jacobian_check"]
    log(f"phase 12a: jacobian_check: {jc}")
    assert jc["chemistry_blowing"] is None            # B'g = 0 clamps
    assert 0.0 <= jc["domain"] < 1e-4 and 0.0 <= jc["cooling_standard"] < 1e-4
    rows = case21_rows(out("c21_lu"))
    log(f"phase 12a: rows {json.dumps(rows)}")
    d_jax = None
    if refs:
        d_jax = rows_rel_diff(rows, JAX_12A)
        log(f"phase 12a: vs the JAX driver's figures: max relative "
            f"difference {d_jax:.3e} (tol 1e-7); linear solves per step "
            f"{ra['newton_iters']} vs {JAX_12A_NEWTON}")
        assert d_jax <= 1e-7 and ra["newton_iters"] == JAX_12A_NEWTON, d_jax

    # -- 12b. scan_stepping: BlockTridiagDirect with the SEB face blocks,
    # writing a checkpoint at t = 0.2
    rb, secs_b, per_step_b, split_b = drive("b scan_stepping", {
        **base, "scan_stepping": True, "output_path": out("c21_scan"),
        "restart_write_file": out("c21_2.chk"), "restart_write_at_time": 0.2,
        "restart_write_at_end": False})
    assert rb["linear_solver"] == "BlockTridiagDirect"
    d_csv = max(csv_agree(os.path.join(out("c21_scan"), name),
                          os.path.join(out("c21_lu"), name), 1e-8)
                for name in ("temperature_probes.csv", "mass_metrics.csv",
                             "boundary_diagnostics.csv"))
    # the Newton CSV: the residual and update columns beside the solves'
    # floor (1e-9 of the column's largest value)
    newton = "newton_history_ablation_case2_1_2D.csv"
    d_newton = csv_agree(os.path.join(out("c21_scan"), newton),
                         os.path.join(out("c21_lu"), newton), 1e-8,
                         floors={3: 1e-9, 5: 1e-9, 6: 1e-9, 8: 1e-9})
    log(f"phase 12b: CSVs vs 12a: max |d| / (1e-8 |a| + floor) = "
        f"{d_csv:.3f}, Newton CSV {d_newton:.3f} (<= 1)")
    assert d_csv <= 1.0 and d_newton <= 1.0, (d_csv, d_newton)
    assert rb["newton_iters"] == ra["newton_iters"]

    # the blowing branch's face blocks on the card: jacobian_check at the
    # state after step 2 (12b's checkpoint), bc at t = 0.3, dt 0.1, where
    # B'g lies inside the table
    c = ablation_case2_1.Case21({**base, "output_path": out("c21_jc")},
                                device, torch.float64)
    _, _, T2, p2, X2 = ablation_case2_1.load_restart(
        out("c21_2.chk"), c.n, c.sys.ne, c.sys.nq, c.mat.num_reactions)
    tens = lambda a: torch.as_tensor(a, device=device)
    T2, p2, X2 = tens(T2), tens(p2), tens(X2)
    To, po = c.ops.values_at_qp(T2), c.ops.values_at_qp(p2)
    bc3, branch3 = c.boundary(0.3)
    T3, p3 = c.enforce_bc(T2, p2, bc3, 0.3)
    reset_counts()
    jc_blow = c.sys.jacobian_check(T3, p3, To, po, X2, 0.1,
                                   seb=c.seb(branch3), bc=bc3)
    bg = float(c.boundary_values(T3, p3, X2, bc3, branch3)[
        c.sys.BOUNDARY_VALUE_KEYS.index("BprimeG_surf")])
    log(f"phase 12b: jacobian_check (domain+face, branch={branch3}) at the "
        f"state after step 2: max rel err {jc_blow}; B'g {bg:.4e}")
    assert branch3 == "chemistry_blowing" and jc_blow is not None \
        and jc_blow < 1e-4 and 1e-4 < bg < 10.0, (jc_blow, bg)

    # the pieces alone at that state: element and face Jacobians, one B'
    # lookup at the face quadrature points, one diagnostics row
    args = (T3, p3, To, po, X2, 0.1)
    jac_ms = ms_per_call(device, lambda: c.sys.element_jacobians(*args))
    face_ms = ms_per_call(device, lambda: c.face_jacobians(T3, p3, X2, bc3,
                                                           branch3))
    res_ms = ms_per_call(device, lambda: c.residual(*args, bc3, branch3))
    nqf = tuple(c.sys.trace.values(T3).shape)
    Tw = c.sys.trace.values(T3)
    bgq = torch.full(nqf, bg, dtype=Tw.dtype, device=Tw.device)
    pwq = torch.full(nqf, bc3.p_w, dtype=Tw.dtype, device=Tw.device)
    lut_ms = ms_per_call(device, lambda: c.bprime.lookup(pwq, bgq, Tw))
    diag_ms = ms_per_call(device, lambda: c.boundary_values(
        T3, p3, X2, bc3, branch3).cpu())
    assert not any(counts().values()), counts()
    c.finish({k: 0.0 for k in ("bc", "residual", "jacobian",
                               "factorization", "linear", "update", "state",
                               "output", "newton", "total")}, 0.0)
    log(f"phase 12b: ms per call (CUDA events): element Jacobians "
        f"{jac_ms:.2f}, face Jacobians {face_ms:.2f}, residual with the SEB "
        f"face term {res_ms:.2f}, B' lookup at the {nqf} face QPs "
        f"{lut_ms:.3f} (one per residual), diagnostics row with its "
        f"read-back {diag_ms:.3f}")
    del c, T2, p2, X2, To, po, T3, p3

    # -- 12c. the restart: an eager run from 12a's t = 0.3 checkpoint
    rc, secs_c, per_step_c, split_c = drive("c restart", {
        **base, "output_path": out("c21_rs"),
        "restart_read_file": out("c21.chk")})
    dT = float(np.abs(rc["T"] - ra["T"]).max())
    dp = float(np.max(np.abs(rc["p"] - ra["p"]) / np.abs(ra["p"])))
    log(f"phase 12c: resumed at t = 0.3 to t = {rc['time']:.3f}: final "
        f"max|dT| {dT:.3e} K (tol 2e-5), max |dp|/|p| {dp:.3e} (tol 1e-7)")
    assert rc["step"] == steps and dT <= 2e-5 and dp <= 1e-7, (dT, dp)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if cuda
            else float("nan"))
    log(f"phase 12: peak device memory {peak:.3f} GiB")

    records.append({
        "driver": "ablation_case2_1", "variant": "host LU (splu)",
        "dofs": 2 * ra["fes"].nscalar, "steps": len(ra["timing"]),
        "run_s": secs, "s_per_step": per_step, "newton_split_s": split,
        "newton_iters_per_step": ra["newton_iters"], "jacobian_check": jc,
        "rows": rows, "vs_jax": d_jax, "peak_mem_gib": peak})
    records.append({
        "driver": "ablation_case2_1", "variant": "scan_stepping (block QR)",
        "dofs": 2 * rb["fes"].nscalar, "steps": len(rb["timing"]),
        "run_s": secs_b, "s_per_step": per_step_b, "newton_split_s": split_b,
        "newton_iters_per_step": rb["newton_iters"],
        "krylov_iters_per_solve": rb["krylov_iters"],
        "csv_vs_host_lu": d_csv, "newton_csv_vs_host_lu": d_newton,
        "blowing_jacobian_check": jc_blow,
        "ms_per_call": {"element_jacobians": jac_ms, "face_jacobians":
                        face_ms, "residual": res_ms, "bprime_lookup": lut_ms,
                        "diagnostics_row": diag_ms}})
    records.append({
        "driver": "ablation_case2_1", "variant": "restart from t = 0.3",
        "steps": len(rc["timing"]), "run_s": secs_c,
        "s_per_step": per_step_c, "max_abs_dT": dT, "max_rel_dp": dp})
    return records


# figures of the JAX driver (cmfem_tpu.apps.ablation_case2_2, float64 on a
# CPU) on phase 13's strip (phase 11's cells split into triangles), deck
# and schedule after 6 steps of dt 0.1: the rows at t = 0.4 (the last
# blowing step) and t = 0.6 of out_c22/temperature_probes.csv (wall,
# TC1..TC8), out_c22/mass_metrics.csv (m_dot_g_surf, m_dot_c,
# front_98_virgin, front_2_char, recession),
# out_c22/boundary_diagnostics.csv (BprimeG_surf, BprimeC_surf,
# q_conv_surf, q_surf) and out_c22/mesh_diagnostics.csv (y_top), and the
# linear solves per step, from, in a scratch directory with PYTHONPATH at
# the repo and CMFEM_FORCE_CPU=1:
#   python -c "from cmfem_tpu_torch.core.mesh import make_strip_mesh_2d,
#              write_gmsh; write_gmsh(make_strip_mesh_2d(11, 239,
#              geom='triangle'), 'strip_tri.msh')"
#   python -m cmfem_tpu.apps.ablation_case2_2 -i case22.yaml
# case22.yaml: case21.yaml's keys with mesh_file: strip_tri.msh,
# bdr_attr_bottom: 1 and output_path: out_c22 (about 4 minutes).
JAX_13A = {
    0.4: {"probes": [797.6700704823648, 439.6243874019435, 327.6873485444437,
                     300.622342715303, 300.0000894900056, 300.0000093015908,
                     300.0000092790766, 300.0000092551921,
                     300.0000092215779],
          "m_dot_g_surf": 0.001696193974321287,
          "m_dot_c": 0.0003286232352275877,
          "BprimeG_surf": 0.005673103993045983,
          "BprimeC_surf": 0.001099115825858991,
          "q_conv_surf": 275862.5646173463, "q_surf": 255760.7633846378,
          "fronts": [6.901081976630474e-06, 0.0],
          "recession": 1.087536967826666e-07,
          "y_top": 0.04999989218834883},
    0.6: {"probes": [580.3020241224309, 468.7746443801251, 353.1308431758689,
                     302.3347811873091, 300.0009300297292, 300.0000044548511,
                     300.0000043080682, 300.0000043252476,
                     300.0000043496241],
          "m_dot_g_surf": 0.0003358296480927275, "m_dot_c": 0.0,
          "BprimeG_surf": 0.0, "BprimeC_surf": 0.0,
          "q_conv_surf": -2803.017881092468, "q_surf": -7878.321096137867,
          "fronts": [1.921057952163768e-05, 0.0],
          "recession": 1.087536967826666e-07,
          "y_top": 0.04999989218834883}}
JAX_13A_NEWTON = [3, 3, 3, 3, 3, 3]
# the same rows of the JAX driver's scan path (warm-started smoothing CG,
# TriStripRemap, TrackedSampler), from case22.yaml's keys with
# scan_stepping: true, output_every: 3 and output_path: out_c22_scan
# (about 4 minutes); 3 linear solves in every step.  They differ from
# JAX_13A: at this size the JAX package's smoothing CG stops on its
# flat-window exit on both paths, each at its own iterate, and the scan
# path samples the fronts on the initial line (ROADMAP, known problem 9).
JAX_13B = {
    0.4: {"probes": [797.6714142242758, 439.625282071731, 327.6876861958291,
                     300.6223488964589, 299.9994294238952, 299.9997098002101,
                     299.9999673840368, 300.0000058226994,
                     300.0000092194496],
          "m_dot_g_surf": 0.001696188408627389,
          "m_dot_c": 0.0003286287262176732,
          "BprimeG_surf": 0.005673085377301933,
          "BprimeC_surf": 0.001099134190930544,
          "q_conv_surf": 275862.0723415339, "q_surf": 255760.1400474708,
          "fronts": [0.0, 0.0], "recession": 1.08753804210757e-07,
          "y_top": 0.0499998921283346},
    0.6: {"probes": [580.303185972103, 468.7755450939093, 353.1312614036366,
                     302.3349567769159, 300.000352731395, 299.9997049091631,
                     299.9999599605044, 300.0000006636623,
                     300.0000043496459],
          "m_dot_g_surf": 0.0003358320744167893, "m_dot_c": 0.0,
          "BprimeG_surf": 0.0, "BprimeC_surf": 0.0,
          "q_conv_surf": -2803.029499589637, "q_surf": -7878.376487397373,
          "fronts": [0.0, 0.0], "recession": 1.08753804210757e-07,
          "y_top": 0.0499998921283346}}
C22_ROW_KEYS = ("probes", "m_dot_g_surf", "m_dot_c", "BprimeG_surf",
                "BprimeC_surf", "q_conv_surf", "q_surf", "fronts",
                "recession", "y_top")
AMARYLLIS = os.path.join(ROOT, "tests", "fixtures",
                         "amaryllis_mass_synthetic.dat")


def c22_vs_jax(rows, ref):
    """(the largest relative difference of every row but the fronts, the
    largest absolute difference of the fronts in m) of two
    ``case22_rows``."""
    keys = tuple(k for k in C22_ROW_KEYS if k != "fronts")
    d_fronts = max(float(np.max(np.abs(np.subtract(rows[t]["fronts"],
                                                   r["fronts"]))))
                   for t, r in ref.items())
    return rows_rel_diff(rows, ref, keys=keys), d_fronts


def case22_rows(out_dir):
    """{t: {C22_ROW_KEYS}} of a case-2.2 run's output rows at t = 0.4 and
    the last t."""
    _, probes = read_csv(os.path.join(out_dir, "temperature_probes.csv"))
    _, mass = read_csv(os.path.join(out_dir, "mass_metrics.csv"))
    hdr, bdr = read_csv(os.path.join(out_dir, "boundary_diagnostics.csv"))
    _, mesh = read_csv(os.path.join(out_dir, "mesh_diagnostics.csv"))
    col = {k: hdr.index(k) for k in ("BprimeG_surf", "BprimeC_surf",
                                     "q_conv_surf", "q_surf")}
    rows = {}
    for i in sorted({int(np.argmin(np.abs(probes[:, 0] - 0.4))),
                     len(probes) - 1}):
        rows[round(float(probes[i, 0]), 6)] = {
            "probes": [float(v) for v in probes[i, 1:]],
            "m_dot_g_surf": float(mass[i, 1]), "m_dot_c": float(mass[i, 2]),
            **{k: float(bdr[i, j]) for k, j in col.items()},
            "fronts": [float(mass[i, 3]), float(mass[i, 4])],
            "recession": float(mass[i, 5]), "y_top": float(mesh[i, 1])}
    return rows


def run_ablation_case22(device, tmp, nx=11, ny=239, steps=6, refs=True):
    """Phase 13: the case-2.2 ablation driver through ``run(cfg)`` on phase
    11's strip split into triangles, with the synthetic deck and B' table
    and the schedule fixture (steps 1-4 recede on the chemistry-blowing
    branch, 5-6 cool and stand still), float64; returns the
    ``ablation_case2_2`` records.  The sizes are arguments so that the
    control flow can be rehearsed small on a CPU; ``refs`` holds (a) to the
    JAX driver's figures above, which belong to the default sizes only."""
    from cmfem_tpu_torch.apps import ablation_case2_2, ablation_case2_2_test
    from cmfem_tpu_torch.core import make_strip_mesh_2d
    from cmfem_tpu_torch.profiling import case22_pieces

    strip = write_gmsh(make_strip_mesh_2d(nx, ny, geom="triangle"),
                       os.path.join(tmp, "strip_tri.msh"))
    out = lambda name: os.path.join(tmp, name)
    base = {"mesh_file": strip, "material_file": TACOT_DECK,
            "boundary_conditions_file": SCHEDULE_C21, "order": 1, "dt": 0.1,
            "t_final": steps * 0.1, "bdr_attr_top": 3, "bdr_attr_bottom": 1,
            "probe_x": 0.00125, "newton_print_level": 0,
            "save_paraview": False, "output_every": 3}
    # the schedule's chemistry is on through the 0.4 s node: those steps
    # recede, the cooling ones stand still (the JAX path's _move/_still)
    moves = [0.1 * k <= 0.4 + 1e-9 for k in range(1, steps + 1)]
    records = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def drive(label, cfg, run=ablation_case2_2.run):
        reset_counts()
        r, secs = timed(lambda: run(cfg, device=device))
        assert not any(counts().values()), counts()
        assert r["converged"] and np.isfinite(r["T"]).all()
        per_step = statistics.median(t["total"] for t in r["timing"])
        split = split_median(r["timing"], keys=(
            "recession", "residual", "jacobian", "factorization", "linear",
            "update", "state", "output"))
        log(f"phase 13{label}: {2 * r['fes'].nscalar} DOFs, "
            f"{len(r['timing'])} steps, run {secs:.2f} s, median "
            f"{per_step:.4f} s/step; split (median s/step): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; linear solves per step {r['newton_iters']}; moved "
            f"{r['moved']}; recession {r['recession_total']:.6e} m")
        return r, secs, per_step, split

    # -- 13a. the eager path: host splu over the element and face blocks on
    # the moved mesh, jacobian_check (the domain blocks with the mesh
    # velocity, once per flux branch with the face blocks), a checkpoint
    # at t = 0.3
    ra, secs, per_step, split = drive("a host LU", {
        **base, "jacobian_check": True, "output_path": out("c22_lu"),
        "restart_write_file": out("c22.chk"), "restart_write_at_time": 0.3,
        "restart_write_at_end": False})
    jc = ra["jacobian_check"]
    log(f"phase 13a: jacobian_check: {jc}")
    assert jc["chemistry_blowing"] is None            # B'g = 0 clamps
    assert 0.0 <= jc["domain"] < 1e-4 and 0.0 <= jc["cooling_standard"] < 1e-4
    hist = np.asarray(ra["recession_history"])
    assert ra["moved"] == moves and hist[1, 1] > 0, (ra["moved"], hist)
    rows = case22_rows(out("c22_lu"))
    log(f"phase 13a: rows {json.dumps(rows)}")
    d_jax = None
    if refs:
        # the JAX figures carry its smoothing CG's flat-window exit, the
        # port's CG runs to its tolerance (ROADMAP, known problem 9)
        d_jax = c22_vs_jax(rows, JAX_13A)
        log(f"phase 13a: vs the JAX driver's figures: max relative "
            f"difference {d_jax[0]:.3e} (tol 2e-4), fronts {d_jax[1]:.3e} m "
            f"(tol 5e-8); linear solves per step {ra['newton_iters']} vs "
            f"{JAX_13A_NEWTON}")
        assert d_jax[0] <= 2e-4 and d_jax[1] <= 5e-8, d_jax
        assert ra["newton_iters"] == JAX_13A_NEWTON

    # -- 13b. scan_stepping: the state, the vertices and the warm-started
    # smoothing velocity on the card, TriStripRemap, TrackedSampler
    rb, secs_b, per_step_b, split_b = drive("b scan_stepping", {
        **base, "scan_stepping": True, "output_path": out("c22_scan")})
    assert rb["linear_solver"] == "BlockTridiagDirect"
    rows_b = case22_rows(out("c22_scan"))
    log(f"phase 13b: rows {json.dumps(rows_b)}")
    d_jax_b = None
    if refs:
        d_jax_b = c22_vs_jax(rows_b, JAX_13B)
        log(f"phase 13b: vs the JAX scan path's figures: max relative "
            f"difference {d_jax_b[0]:.3e} (tol 2e-4), fronts "
            f"{d_jax_b[1]:.3e} m (tol 5e-8)")
        assert d_jax_b[0] <= 2e-4 and d_jax_b[1] <= 5e-8, d_jax_b
        assert rb["newton_iters"] == JAX_13A_NEWTON
    # against 13a: the same moves and Newton counts; both paths' smoothing
    # CGs run to their tolerance, from a cold and a warm start, so the
    # vertices and the fields agree to the CG's and Newton's roundoff; the
    # CSVs differ in the fronts, which the scan path samples on the
    # initial line
    d_csv = max(csv_agree(os.path.join(out("c22_scan"), name),
                          os.path.join(out("c22_lu"), name), 1e-8)
                for name in ("temperature_probes.csv", "mass_metrics.csv",
                             "boundary_diagnostics.csv",
                             "pressure_probes.csv", "mesh_diagnostics.csv",
                             "mass_eq_probe_diagnostics.csv"))
    vmax = float(np.abs(ra["vertices"]).max())
    d_verts = float(np.abs(rb["vertices"] - ra["vertices"]).max())
    d_rec = abs(rb["recession_total"] - ra["recession_total"]) \
        / ra["recession_total"]
    d_T = float(np.abs(rb["T"] - ra["T"]).max() / np.abs(ra["T"]).max())
    d_p = float(np.abs(rb["p"] - ra["p"]).max() / np.abs(ra["p"]).max())
    log(f"phase 13b: vs 13a: CSVs max |d| / (1e-8 |a| + floor) = "
        f"{d_csv:.3e}; vertices max|d| {d_verts:.3e} m = "
        f"{d_verts / vmax:.3e} of max|v| (the recession "
        f"{ra['recession_total']:.3e} m); recession rel {d_rec:.3e}; T "
        f"{d_T:.3e}, p {d_p:.3e} of max; moved {rb['moved']}")
    assert rb["newton_iters"] == ra["newton_iters"]
    assert rb["moved"] == ra["moved"]
    assert d_verts <= 1e-12 * vmax and d_rec <= 1e-8, (d_verts, d_rec)
    assert d_T <= 1e-8 and d_p <= 1e-8, (d_T, d_p)

    # the front line's first crossing on the card: torch.argmax of the
    # crossing mask (an integer cast) must return the FIRST True, as the
    # host front_depth_from_line's scan does, with crossings far apart
    from cmfem_tpu_torch.core.pointlocate import front_depth_from_line
    from cmfem_tpu_torch.core.tracksample import (front_depth_from_samples,
                                                  line_points)

    ys = line_points(0.00125, 0.05, 0.0)[:, 1]
    vals = np.zeros(len(ys))
    vals[97:150] = 1.0
    vals[200:] = 1.0
    first = [float(front_depth_from_samples(
        torch.as_tensor(vals, device=device),
        torch.as_tensor(ys, device=device), 0.05, thr)) for thr in (0.5, 1.0)]
    host = [front_depth_from_line(vals, ys, 0.05, thr) for thr in (0.5, 1.0)]
    log(f"phase 13b: first crossing on the {torch.device(device).type}: "
        f"{first} (host {host})")
    assert np.allclose(first, host, rtol=1e-12, atol=0) and first[0] > 0

    # the pieces of a receding step alone, at 13b's final state with the
    # blowing boundary of t = 0.3
    pieces, c = case22_pieces({**base, "output_path": out("c22_pc")}, rb,
                              device)
    reset_counts()
    piece_ms = {label: ms_per_call(device, fn, reps=3, warmup=1)
                for label, fn in pieces.items()}
    assert not any(counts().values()), counts()
    c.finish({k: 0.0 for k in ablation_case2_2.TIMING_KEYS
              + ("newton", "total")}, 0.0)
    log("phase 13b: ms per call (CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in piece_ms.items()))

    # -- 13e. ROADMAP C10: is the smoothing CG repeatable?  The 5,760-DOF
    # LaplacianSmoother.solve of 13b's pieces, 10 times cold and 10 times
    # warm (13b's warm start) on identical inputs: each solve's iteration
    # count and the largest difference between the iterates
    repeat = {}
    for label, kind in (("smoothing CG, cold start", "cold"),
                        ("smoothing CG, warm start", "warm")):
        sols = [pieces[label]() for _ in range(10)]
        repeat[kind] = {
            "iters": [s.iters for s in sols],
            "rel_residual": [s.rel_residual for s in sols],
            "max_abs_dx": max(float((s.x - sols[0].x).abs().max())
                              for s in sols),
            "bitwise_equal": all(torch.equal(s.x, sols[0].x) for s in sols)}
        log(f"phase 13e: {label}, 10 repeats: iterations "
            f"{repeat[kind]['iters']}, max|x_i - x_0| "
            f"{repeat[kind]['max_abs_dx']:.3e}, bit for bit "
            f"{repeat[kind]['bitwise_equal']}")
        del sols
    assert all(r["bitwise_equal"] for r in repeat.values()), repeat
    del pieces, c

    # -- 13c. the restart: an eager run from 13a's t = 0.3 checkpoint, on
    # the receded mesh it carries
    rc, secs_c, per_step_c, split_c = drive("c restart", {
        **base, "output_path": out("c22_rs"),
        "restart_read_file": out("c22.chk")})
    dT = float(np.abs(rc["T"] - ra["T"]).max())
    dp = float(np.max(np.abs(rc["p"] - ra["p"]) / np.abs(ra["p"])))
    dv = float(np.abs(rc["vertices"] - ra["vertices"]).max()) / vmax
    log(f"phase 13c: resumed at t = 0.3 to t = {rc['time']:.3f}: final "
        f"max|dT| {dT:.3e} K (tol 2e-5), max |dp|/|p| {dp:.3e} (tol 1e-7), "
        f"vertices max|d| / max|v| {dv:.3e} (tol 1e-12), recession "
        f"{rc['recession_total']:.6e} m")
    assert rc["step"] == steps and dT <= 2e-5 and dp <= 1e-7, (dT, dp)
    assert dv <= 1e-12 and rc["moved"] == moves[3:], (dv, rc["moved"])
    assert abs(rc["recession_total"] - ra["recession_total"]) <= \
        1e-8 * ra["recession_total"]

    # -- 13d. the study variant: GCL storage, the Amaryllis metrics
    rd, secs_d, per_step_d, split_d = drive("d study variant", {
        **base, "t_final": 0.1, "output_path": out("c22_study"),
        "amaryllis_mass_file": AMARYLLIS}, run=ablation_case2_2_test.run)
    metrics = rd["recession_metrics"]
    log(f"phase 13d: recession vs the synthetic Amaryllis history: "
        f"{metrics}")
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert os.path.exists(os.path.join(out("c22_study"),
                                       "recession_error_metrics.csv"))
    assert rd["moved"] == moves[:1]
    peak = (torch.cuda.max_memory_allocated() / 2**30 if cuda
            else float("nan"))
    log(f"phase 13: peak device memory {peak:.3f} GiB")

    records.append({
        "driver": "ablation_case2_2", "variant": "host LU (splu)",
        "dofs": 2 * ra["fes"].nscalar, "elements": ra["mesh"].num_elements,
        "steps": len(ra["timing"]), "run_s": secs, "s_per_step": per_step,
        "split_s": split, "newton_iters_per_step": ra["newton_iters"],
        "moved": ra["moved"], "recession_m": ra["recession_total"],
        "jacobian_check": jc, "rows": rows, "vs_jax": d_jax,
        "peak_mem_gib": peak, "first_step": first_step_rows(out("c22_lu"),
                                                            ra)})
    records.append({
        "driver": "ablation_case2_2", "variant": "scan_stepping (block QR)",
        "dofs": 2 * rb["fes"].nscalar, "steps": len(rb["timing"]),
        "run_s": secs_b, "s_per_step": per_step_b, "split_s": split_b,
        "newton_iters_per_step": rb["newton_iters"], "moved": rb["moved"],
        "krylov_iters_per_solve": rb["krylov_iters"],
        "rows": rows_b, "vs_jax_scan": d_jax_b, "csv_vs_host_lu": d_csv,
        "vertices_vs_host_lu_m": d_verts, "T_vs_host_lu": d_T,
        "recession_vs_host_lu": d_rec, "ms_per_call": piece_ms,
        "smoothing_cg_repeats": repeat})
    records.append({
        "driver": "ablation_case2_2", "variant": "restart from t = 0.3",
        "steps": len(rc["timing"]), "run_s": secs_c,
        "s_per_step": per_step_c, "max_abs_dT": dT, "max_rel_dp": dp,
        "vertices_vs_straight": dv})
    records.append({
        "driver": "ablation_case2_2_test", "variant": "study (GCL storage)",
        "steps": len(rd["timing"]), "run_s": secs_d,
        "s_per_step": per_step_d, "recession_metrics": metrics})
    return records


# inner GMRES iterations of the JAX package's BlockNewtonKrylov(pc="linemg")
# (restart 400, rtol 1e-12) on phase 14a's two systems, the first Newton
# system of phase 11a's step 1 on the strip and on the strip refined twice,
# built by the port on a CPU and handed to both packages as numpy arrays:
#   python tests/jax_linemg_counts.py
# (about three minutes on a CPU).
JAX_14A_LINEMG = {5_760: 35, 86_130: 56}


def linemg_kernels_vs_plain(device, hierarchy, timing=False):
    """The line-MG kernels of a hierarchy of phase 14a (outside the counted
    runs).  At the finest level: the kernels' factors and solve of a seeded
    r against the plain factors and solve, and the solve kernel on the
    plain factors against the plain solve (max|x_k - x_p| / max|x_p| <=
    1e-8, float64; the QR's signs may differ, so factors are compared
    through their solves).  At every level: the kernels' line residual
    |A_line x - r| / |r| at most 1e-10 (the line blocks are SS's, so this
    holds the factor kernel too), and within 10 times, plus 1e-13, the
    plain solve's on the kernels' factors (the plain factorization takes
    seconds a level, so it runs at the finest only); two solves on the
    same inputs equal bit for bit; the built kernel's launch geometry
    equal to ``klmg.solve_geometry``.  With ``timing`` each kernel is
    timed at every level (``klmg.level_times``: device ms from a replayed
    CUDA graph, and ms of one call between CUDA events) beside its bound,
    and the plain versions at the finest."""
    gen = torch.Generator(device=device).manual_seed(14)
    SS, fac = hierarchy[0]
    NY, NX = SS.shape[2], SS.shape[3]
    plain, plain_s = timed(lambda: tuple(
        t.contiguous() for t in klmg.line_factor_plain(SS)))
    r = torch.randn((NY, NX, 2), generator=gen, dtype=SS.dtype,
                    device=device)
    xp = klmg.line_solve_plain(plain, r)
    scale = float(xp.abs().max())
    abs_errs = {key: float((klmg.line_solve(fk, r) - xp).abs().max())
                for key, fk in (("factor_and_solve", fac), ("solve", plain))}
    errs = {k: v / scale for k, v in abs_errs.items()}
    log(f"phase 14a: line-MG kernels vs plain at the finest level (NY={NY}, "
        f"NX={NX}; {len(hierarchy)} levels), float64: factor + solve "
        f"{errs['factor_and_solve']:.3e}, solve on the plain factors "
        f"{errs['solve']:.3e} (tol 1e-8)")
    assert max(errs.values()) <= 1e-8, errs
    out = {"levels": len(hierarchy), "NY": NY, "NX": NX,
           "max_rel_err": errs, "max_abs_err": abs_errs, "by_level": []}
    for level, (SSl, facl) in enumerate(hierarchy):
        nx = SSl.shape[3]
        rl = torch.randn((NY, nx, 2), generator=gen, dtype=SS.dtype,
                         device=device)
        xk = klmg.line_solve(facl, rl)
        repeat = bool(torch.equal(klmg.line_solve(facl, rl), xk))
        res_k = line_residual(SSl, xk, rl)
        res_p = line_residual(SSl, klmg.line_solve_plain(facl, rl), rl)
        geometry = klmg.kernel_solve_geometry(NY, nx, SS.element_size())
        rec = {"level": level, "NX": nx, "line_residual": res_k,
               "plain_line_residual": res_p, "repeat_bit_for_bit": repeat,
               "solve_geometry": geometry}
        msg = (f"phase 14a: level {level} (NY={NY}, NX={nx}): line residual "
               f"{res_k:.3e} (plain solve {res_p:.3e}), repeat bit for bit "
               f"{repeat}, geometry {geometry}")
        if timing:
            times = klmg.level_times(SSl, facl, rl)
            rec.update(times)
            msg += "; " + klmg.describe(times)
        log(msg)
        assert repeat, level
        assert res_k <= 1e-10, (level, res_k)
        assert res_k <= 10 * res_p + 1e-13, (level, res_k, res_p)
        assert geometry == klmg.solve_geometry(NY, nx, SS.element_size()), \
            (level, geometry)
        out["by_level"].append(rec)
    if not timing:
        return out
    plain_ms = {
        "line_factor": 1e3 * plain_s,
        "line_solve": median_ms(lambda: klmg.line_solve_plain(plain, r),
                                reps=2, warmup=1)}
    for name in ("line_factor", "line_solve"):
        top = out["by_level"][0][name]
        t = out[name] = {"ms": top["ms"], "call_ms": top["call_ms"],
                         "plain_ms": plain_ms[name],
                         "bound": (top["bound_ms"], top["bound_by"])}
        log(f"phase 14a: {name} at NY={NY}, NX={NX}, float64: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]})")
    return out


def factor_chain_floor(records):
    """``line_factor``'s chain: its device ms at the coarsest level (NX = 1)
    of the two hierarchies of phase 14a, NY = 240 and 957; the slope is the
    chain's ms per row, and the floor at NY = 957 that slope times the 956
    rows (a recurrence over the rows takes no less)."""
    pts = []
    for rec in records:
        SS, _ = rec.pop("coarsest")
        pts.append((SS.shape[2], graph_ms(lambda: klmg.line_factor(SS))))
    (ny0, ms0), (ny1, ms1) = pts
    per_row = (ms1 - ms0) / (ny1 - ny0)
    out = {"ms_per_row": per_row, "NY": ny1, "floor_ms": per_row * (ny1 - 1),
           "coarsest_ms": {str(ny0): ms0, str(ny1): ms1}}
    log(f"phase 14a: line_factor's chain {1e3 * per_row:.4f} us a row "
        f"(NX=1: {ms0:.4f} ms at NY={ny0}, {ms1:.4f} ms at NY={ny1}); "
        f"floor at NY={ny1} {out['floor_ms']:.4f} ms")
    return out


def run_linemg(device, tmp, ref_levels=2, refs=True, pointblock_iters=None):
    """Phase 14a: ``BlockNewtonKrylov(pc="linemg")`` (restart 400, rtol
    1e-12) on the first Newton system of 11a (5,760 DOFs) and of 11d's
    strip (``ref_levels`` refinements, 86,130 DOFs): inner iterations,
    set-up ms, solve s, the true relative residual on the host matrix, and
    the direction against the direct solve (host ``splu`` on the strip,
    ``BlockTridiagDirect`` refined), to 1e-8.  ``pointblock_iters`` is
    phase 11c's point-block count on the first system (the point-block
    GMRES on both systems: ``python -m cmfem_tpu_torch.profiling
    --sections linemg``)."""
    from cmfem_tpu_torch.apps import ablation_case1
    from cmfem_tpu_torch.profiling import first_newton_system
    from cmfem_tpu_torch.solvers.blocksolve import (
        BlockNewtonKrylov, BlockTridiagDirect, strip_dof_lattice)

    records = []
    for lv in (0, ref_levels):
        c, blocks, R = first_newton_system(device, tmp, lv, f"lmg{lv}")
        b = -R
        lat = strip_dof_lattice(c.fes.node_positions)
        ed = c.fes.element_dofs
        if lv == 0:
            d_dir, dir_s = timed(lambda: c.host_lu(blocks).solve(b))
            direct = "host splu"
        else:
            btd = BlockTridiagDirect(ed, c.n, c.ess, c.ess, dof_lattice=lat,
                                     device=device)
            d_dir, dir_s = timed(lambda: btd.solve(btd.prepare(blocks), b,
                                                   rtol=1e-12).x)
            direct = "BlockTridiagDirect"
        A = c.host_matrix(blocks)
        b_np = b.cpu().numpy()
        true_rel = lambda x: float(np.linalg.norm(A @ x.cpu().numpy() - b_np)
                                   / np.linalg.norm(b_np))
        rec = {"driver": "ablation_case1", "variant":
               "linemg (GMRES(400), rtol 1e-12), one Newton system",
               "dofs": 2 * c.n, "direct": direct, "direct_s": dir_s,
               "direct_true_rel": true_rel(d_dir)}
        bks = BlockNewtonKrylov(ed, c.n, c.ess, c.ess, restart=400,
                                maxiter=10, dof_lattice=lat, pc="linemg",
                                device=device)
        reset_counts()
        fac, setup_s = timed(lambda: bks.prepare(blocks))
        res, solve_s = timed(lambda: bks.solve(fac, b, rtol=1e-12))
        launched = counts()
        moved = {k for k, v in launched.items() if v}
        assert moved == {"line_factor", "line_solve"}, launched
        d = rel2(res.x, d_dir)
        tr = true_rel(res.x)
        rec["linemg"] = {"inner_iters": res.inner_iters,
                         "restart_cycles": res.iters,
                         "converged_flag": res.converged,
                         "setup_ms": 1e3 * setup_s, "solve_s": solve_s,
                         "true_rel_residual": tr, "direction_vs_direct": d,
                         "launches": {k: launched[k] for k in moved}}
        log(f"phase 14a: {2 * c.n} DOFs, pc=linemg: {res.inner_iters} inner "
            f"iterations ({res.iters} cycles), set-up {1e3 * setup_s:.1f} "
            f"ms, solve {solve_s:.3f} s, true rel residual {tr:.3e} "
            f"({direct}: {rec['direct_true_rel']:.3e}), direction vs "
            f"{direct} {d:.3e} (tol 1e-8); launches "
            f"{rec['linemg']['launches']}")
        assert d <= 1e-8, d
        hierarchy = fac[1]
        del bks, fac
        rec["kernels"] = linemg_kernels_vs_plain(device, hierarchy,
                                                 timing=lv > 0)
        rec["coarsest"] = hierarchy[-1]
        del hierarchy
        if lv == 0 and pointblock_iters is not None:
            rec["pointblock"] = {"inner_iters": pointblock_iters,
                                 "from": "phase 11c"}
        if refs and JAX_14A_LINEMG.get(2 * c.n) is not None:
            want = JAX_14A_LINEMG[2 * c.n]
            log(f"phase 14a: {2 * c.n} DOFs: linemg inner iterations "
                f"{rec['linemg']['inner_iters']} vs the JAX package's {want}")
            assert rec["linemg"]["inner_iters"] == want
        c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                  + ("newton", "total")}, 0.0)
        records.append(rec)
        del c, blocks, R, A
    chain = factor_chain_floor(records)
    records[-1]["kernels"]["line_factor"]["chain"] = chain
    return records


def run_distributed(device, tmp, n=48, order=2, reps=10):
    """Phase 14b: the distributed operator layer at full width in a world
    of one rank over NCCL (gloo on a CPU), in this process: on n^3 hexes at
    ``order`` (48^3, order 2: 912,673 DOFs), float64 and float32,
    ``ShardedPoissonApply`` on the CDR form and ``DofPartitionedOperator``
    on the SPD form against ``BilinearForm.apply`` (f64 1e-12, f32 1e-5 of
    max|y|), ``ShardedSumFactOperator`` against ``SumFactoredOperator``'s
    plain chain (same tolerances), and a Jacobi-CG on the
    ``DofPartitionedOperator`` (f64, rtol 1e-8) with the single-device CG's
    iteration count; each apply's ms (CUDA events, median of ``reps``)
    beside the single-device path's; peak device memory."""
    import torch.distributed as dist

    from cmfem_tpu_torch.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu_torch.parallel import (DofPartitionedOperator,
                                          ShardedPoissonApply, init_rank,
                                          make_device_mesh)
    from cmfem_tpu_torch.solvers import cg, jacobi_preconditioner

    cuda = torch.device(device).type == "cuda"
    ms = (lambda fn: median_ms(fn, reps=reps, warmup=2)) if cuda else \
        (lambda fn: timed(fn)[1] * 1e3)
    init_rank(0, 1, os.path.join(tmp, "store14b"), device=device)
    try:
        mesh = make_device_mesh(1, device=device)
        zmesh = make_device_mesh(1, axis="z", device=device)
        rec = {"world_size": mesh.size, "backend": dist.get_backend()}
        fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
        gen = np.random.default_rng(14)
        u64 = torch.as_tensor(gen.standard_normal(fes.nscalar),
                              device=device)
        b = torch.as_tensor(gen.standard_normal(fes.nscalar), device=device)
        refs = {}
        for dtype in (torch.float64, F32):
            name = str(dtype)[6:]
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ops = SpaceOps(fes, quad_order=2 * order, device=device,
                           dtype=dtype)
            cform = cdr(BilinearForm(ops))
            cdata = cform.assemble()
            sform = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1 * DT)
            sdata = sform.assemble()
            u = u64.to(dtype)
            if dtype == torch.float64:
                refs = {"cdr": cform.apply(cdata, u), "spd":
                        sform.apply(sdata, u)}
            out = {"dofs": fes.nscalar, "setup_s": time.perf_counter() - t0}
            for label, build, form, data, key in (
                    ("ShardedPoissonApply (CDR)", ShardedPoissonApply, cform,
                     cdata, "cdr"),
                    ("DofPartitionedOperator (SPD)", DofPartitionedOperator,
                     sform, sdata, "spd")):
                op, set_s = timed(lambda: build(ops, data, mesh))
                dist_op = label.startswith("Dof")
                y = op.from_dist(op(op.to_dist(u))) if dist_op else op(u)
                err = rel_err(y.double(), refs[key])
                ud = op.to_dist(u) if dist_op else u
                out[label] = {"max_rel_err": err, "setup_s": set_s,
                              "ms": ms(lambda: op(ud)),
                              "single_device_ms": ms(
                                  lambda: form.apply(data, u))}
                log(f"phase 14b: {label} {name}: {fes.nscalar} DOFs, "
                    f"max|y - BilinearForm.apply|/max|y| = {err:.3e} (tol "
                    f"{TOL[dtype]:.0e}); apply {out[label]['ms']:.3f} ms, "
                    f"single-device BilinearForm.apply "
                    f"{out[label]['single_device_ms']:.3f} ms")
                assert err <= TOL[dtype], (label, dtype, err)
                if dist_op and dtype == torch.float64:
                    diag = sform.assemble_diagonal(sdata)
                    ref_cg, ref_s = timed(lambda: cg(
                        lambda v: sform.apply(sdata, v), b,
                        M=jacobi_preconditioner(diag), rtol=1e-8,
                        maxiter=2000))
                    dinv = op.to_dist(1.0 / diag)
                    res, cg_s = timed(lambda: cg(
                        op, op.to_dist(b), M=lambda r: dinv * r, rtol=1e-8,
                        maxiter=2000, dot=op.dot, norm=op.norm))
                    dx = rel2(op.from_dist(res.x), ref_cg.x)
                    out[label]["cg"] = {
                        "iters": res.iters, "single_device_iters":
                        ref_cg.iters, "s": cg_s, "single_device_s": ref_s,
                        "x_rel": dx, "converged": res.converged}
                    log(f"phase 14b: Jacobi-CG (rtol 1e-8) on the "
                        f"DofPartitionedOperator: {res.iters} iterations "
                        f"(single device {ref_cg.iters}), {cg_s:.3f} s "
                        f"({ref_s:.3f}); x vs single device {dx:.3e}")
                    assert res.converged and res.iters == ref_cg.iters, \
                        (res.iters, ref_cg.iters)
                    assert dx <= 1e-8, dx
                del op, y, ud
            shop, set_s = timed(lambda: ShardedSumFactOperator(
                ops, cdata, n, n, n, order, zmesh, dtype=dtype))
            fn, D = shop.base.bind()
            ul = shop.to_sharded(u)
            err = rel_err(shop.from_sharded(shop(ul)), fn(u, D))
            out["ShardedSumFactOperator (CDR)"] = {
                "max_rel_err": err, "setup_s": set_s,
                "ms": ms(lambda: shop(ul)),
                "single_device_ms": ms(lambda: fn(u, D))}
            log(f"phase 14b: ShardedSumFactOperator {name}: max|y - plain "
                f"chain|/max|y| = {err:.3e} (tol {TOL[dtype]:.0e}); apply "
                f"{out['ShardedSumFactOperator (CDR)']['ms']:.3f} ms, plain "
                f"chain {out['ShardedSumFactOperator (CDR)']['single_device_ms']:.3f}"
                f" ms")
            assert err <= TOL[dtype], (dtype, err)
            del shop, fn, D, ul
            out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else float("nan"))
            log(f"phase 14b: {name}: peak device memory "
                f"{out['peak_mem_gib']:.3f} GiB")
            rec[name] = out
            del ops, cform, cdata, sform, sdata
        del refs
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def dist_small_rank(n_devices, device, p2p_only=False):
    """A rank of phase 14c: on n^3 hexes at order 2 (float64), the
    collective operators (``ShardedPoissonApply``, ``DofPartitionedOperator``
    with its Jacobi-CG against the single-device CG), or with ``p2p_only``
    the z-split ``ShardedSumFactOperator`` (its halo is point-to-point),
    each against its single-device apply.  Any error propagates, but for
    gloo's transport refusing the z-split exchange on CUDA tensors
    (``gloo_refusal``), which is recorded instead."""
    from cmfem_tpu_torch.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu_torch.parallel import (DofPartitionedOperator,
                                          ShardedPoissonApply,
                                          make_device_mesh)
    from cmfem_tpu_torch.solvers import cg, jacobi_preconditioner

    mesh = make_device_mesh(n_devices, device=device)
    dev = mesh.device
    n = 8
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), 2)
    ops = SpaceOps(fes, quad_order=4, device=dev)
    cform = cdr(BilinearForm(ops))
    cdata = cform.assemble()
    sform = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    sdata = sform.assemble()
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        fes.nscalar), device=dev)
    out = {"rank": mesh.rank, "device": str(dev)}

    def sharded():
        op = ShardedPoissonApply(ops, cdata, mesh)
        return {"max_rel_err": rel_err(op(u), cform.apply(cdata, u))}

    def dofpart():
        op = DofPartitionedOperator(ops, sdata, mesh)
        y = op.from_dist(op(op.to_dist(u)))
        diag = sform.assemble_diagonal(sdata)
        ref = cg(lambda v: sform.apply(sdata, v), u,
                 M=jacobi_preconditioner(diag), rtol=1e-10, maxiter=500)
        dinv = op.to_dist(1.0 / diag)
        res = cg(op, op.to_dist(u), M=lambda r: dinv * r, rtol=1e-10,
                 maxiter=500, dot=op.dot, norm=op.norm)
        return {"max_rel_err": rel_err(y, sform.apply(sdata, u)),
                "cg_iters": res.iters, "single_device_iters": ref.iters,
                "x_rel": rel2(op.from_dist(res.x), ref.x)}

    def zsplit():
        op = ShardedSumFactOperator(ops, cdata, n, n, n, 2, mesh,
                                    dtype=torch.float64)
        fn, D = op.base.bind()
        return {"max_rel_err": rel_err(op.from_sharded(op(op.to_sharded(u))),
                                       fn(u, D))}

    if not p2p_only:
        out["ShardedPoissonApply"] = sharded()
        out["DofPartitionedOperator"] = dofpart()
        return out
    try:
        out["ShardedSumFactOperator"] = zsplit()
    except RuntimeError as e:
        if dev.type != "cuda" or gloo_refusal(str(e)) is None:
            raise
        out["ShardedSumFactOperator"] = {"error": gloo_refusal(str(e))}
    return out


def gloo_refusal(text):
    """The first line of gloo's TCP transport failing a point-to-point
    exchange of CUDA tensors (it reads the device pointer as host memory:
    ``pair.cc ... writev ... Bad address`` on the sender, ``Connection
    closed by peer`` on the other rank, or the same as an abort's last
    words in a dead rank's stderr), or None for any other error."""
    m = re.search(r"\[[^\]\n]*gloo/transport/tcp/pair\.cc:\d+\] "
                  r"(writev|Read error|Connection closed by peer)[^\n]*", text)
    return None if m is None else m.group(0)


def run_gloo_on_card(device, world=2, timeout=120):
    """Phase 14c: the halo code on CUDA tensors: ``world`` gloo ranks on
    the one card (NCCL takes one rank per card), each operator against its
    single-device apply (1e-12 of max|y|; CG iteration counts equal, x to
    1e-8).  An operator that gloo refuses on CUDA tensors is named with
    gloo's error (for a rank that dies in the exchange, from the last
    lines of its stderr); that is the only failure it passes over: any
    other error of any operator fails the phase."""
    from cmfem_tpu_torch.parallel import spawn_ranks

    kind = torch.device(device).type

    def spawn(p2p_only):
        try:
            return spawn_ranks(dist_small_rank, world, (world, kind,
                                                        p2p_only),
                               device=device, backend="gloo",
                               timeout=timeout)
        except RuntimeError as e:  # a rank died: its stderr's last lines
            if not p2p_only or kind != "cuda" or gloo_refusal(str(e)) is None:
                raise
            return [{"ShardedSumFactOperator":
                     {"error": gloo_refusal(str(e))}}] * world

    # the collective operators and the point-to-point one in two worlds at
    # once: a rank that gloo kills in the exchange takes only its own world
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        collective, p2p = pool.map(spawn, (False, True))
    ranks = [{**a, **b} for a, b in zip(collective, p2p)]
    rec = {}
    for name in ("ShardedPoissonApply", "DofPartitionedOperator",
                 "ShardedSumFactOperator"):
        got = [r[name] for r in ranks]
        errors = sorted({g["error"] for g in got if "error" in g})
        if errors:
            assert name == "ShardedSumFactOperator" and all(
                gloo_refusal(e) == e for e in errors), (name, errors)
            rec[name] = {"refused": errors}
            log(f"phase 14c: {name}, {world} gloo ranks on CUDA tensors: "
                f"refused: " + " | ".join(errors))
            continue
        err = max(g["max_rel_err"] for g in got)
        rec[name] = {"max_rel_err": err}
        extra = ""
        if name == "DofPartitionedOperator":
            rec[name].update({k: got[0][k] for k in
                              ("cg_iters", "single_device_iters", "x_rel")})
            extra = (f"; CG {got[0]['cg_iters']} iterations (single device "
                     f"{got[0]['single_device_iters']}), x vs single device "
                     f"{got[0]['x_rel']:.3e}")
            assert all(g["cg_iters"] == g["single_device_iters"]
                       and g["x_rel"] <= 1e-8 for g in got), got
        log(f"phase 14c: {name}, {world} gloo ranks on "
            f"{ranks[0]['device']}: max rel err vs single device {err:.3e} "
            f"(tol 1e-12){extra}")
        assert err <= 1e-12, (name, err)
    return rec


def ablation_residual_in_turns(device, r):
    """The case-1 residual at a run's final state, through the generic path
    (gather, index_add_) and the lattice path (strided windows), in turns
    (generic, lattice, lattice, generic), median ms of one call between
    CUDA events (host clock with the device synchronized on a CPU); the two
    agree to 1e-12.  The refined strip's elements are renumbered row-major
    (order-1 DOFs are the vertices, so the fields keep their numbering)."""
    from cmfem_tpu_torch.core import FESpace
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.ops.lattice2d import (
        reorder_mesh_elements, strip_element_order)
    from cmfem_tpu_torch.physics.ablation import AblationSystem
    from cmfem_tpu_torch.physics.tacot import TacotMaterial
    from cmfem_tpu_torch.solvers.blocksolve import strip_dof_lattice

    order = strip_element_order(r["mesh"])
    fes = FESpace(reorder_mesh_elements(r["mesh"], order), 1)
    sys_ = AblationSystem(SpaceOps(fes, quad_order=4, device=device),
                          TacotMaterial.load_yaml(TACOT_DECK), top_attr=3)
    T = torch.as_tensor(r["T"], device=device)
    p = torch.as_tensor(r["p"], device=device)
    X = r["state"].extent[torch.as_tensor(order, device=device)]
    args = (T, p, sys_.ops.values_at_qp(T - 1.0), sys_.ops.values_at_qp(p),
            X, 0.1)
    windows = {"generic": None,
               "lattice": sys_.set_dof_lattice(
                   strip_dof_lattice(fes.node_positions))}

    def call(path):
        sys_.lat = windows[path]
        return sys_.residual(*args)

    for a, b in zip(call("generic"), call("lattice")):
        assert rel_err(b, a) <= 1e-12, rel_err(b, a)
    paths = {}
    for path in ("generic", "lattice", "lattice", "generic"):
        paths.setdefault(path, []).append(
            ms_per_call(device, lambda: call(path), reps=10))
    return paths


def rel_max(a, b):
    """max|a - b| / max|b| of two tensors."""
    return float((a - b).abs().max() / b.abs().max())


def newton_pieces(nw, dofpart, T, p, slabs, dt, bc=None):
    """One class's Newton system at (T, p): (the global residual, the
    ``prepare`` factors, ``solve(factors, rtol)`` of J dx = -R, the map of
    a distributed vector to the global layout, the residual and
    ``prepare`` calls alone, and (T, p) in the class's vector layout)."""
    if dofpart:
        y = nw.to_dist2(T, p)
        Rd = nw.residual(y, *slabs, dt, bc=bc)
        fac = nw.prepare(y, *slabs, dt, bc=bc)
        glob = lambda v: torch.cat(nw.gather2(v))
        return (glob(Rd), fac, lambda f, r: nw.solve(f, -Rd, rtol=r),
                glob, lambda: nw.residual(y, *slabs, dt, bc=bc),
                lambda: nw.prepare(y, *slabs, dt, bc=bc), y)
    R = nw.residual(T, p, *slabs, dt, bc=bc)
    fac = nw.prepare(T, p, *slabs, dt, bc=bc)
    return (R, fac, lambda f, r: nw.solve(f, -R, rtol=r), lambda v: v,
            lambda: nw.residual(T, p, *slabs, dt, bc=bc),
            lambda: nw.prepare(T, p, *slabs, dt, bc=bc), torch.cat([T, p]))


def class_slabs(nw, dofpart, *arrays):
    return tuple(nw.pack_elem(a, "dup") if dofpart else nw.pad_elem(a)
                 for a in arrays)


def run_distributed_ablation(device, tmp, first_c1, first_c22, nx=11,
                             ny=239, ref_levels=2, reps=5, rtol=1e-13):
    """Phases 15a and 15b: the distributed ablation Newton in a world of
    one rank over NCCL (gloo on a CPU), in this process, float64.

    15a, at the deck's size (``nx`` x ``ny`` strip, 5,760 DOFs): on the
    first Newton system of case 2.1's step 1 (SEB on the
    chemistry-blowing branch) and of case 1's, each class's residual
    against the single-device residual (1e-12 of max|R|), on case 1's its
    Newton direction (GMRES at ``rtol``) against ``splu``'s per field
    (1e-7), with ms per residual, ``prepare`` and matvec call, GMRES
    iterations, per-rank floats; then one case-1 step with
    ``dof_partition: 1`` and one case-2.2 step with ``sharding_devices:
    1`` through ``run(cfg)``,
    held against 11a's and 13a's first-step rows (``first_c1``,
    ``first_c22``: T to 1e-6; p (2.2's pressure probes, case 1's m_dot_g)
    to 1e-8; the same linear solves), with s per step and the Newton
    split.  15b, on case 1's first system on the strip refined
    ``ref_levels`` times (86,130 DOFs): the residual, ``prepare``'s
    Je_s/pb/s and one matvec of each class against the single-device path
    (``BlockNewtonKrylov`` on the element blocks), to 1e-12, ms per call
    beside the single-device path's; peak device memory of each."""
    import torch.distributed as dist

    from cmfem_tpu_torch.apps import (ablation_case1, ablation_case2_1,
                                      ablation_case2_2)
    from cmfem_tpu_torch.core import make_strip_mesh_2d
    from cmfem_tpu_torch.parallel import (DofPartitionedAblationNewton,
                                          ShardedAblationNewton, init_rank,
                                          make_device_mesh)
    from cmfem_tpu_torch.solvers.blocksolve import BlockNewtonKrylov

    cuda = torch.device(device).type == "cuda"
    classes = (("sharded", ShardedAblationNewton, False),
               ("dofpart", DofPartitionedAblationNewton, True))
    ms = lambda fn: ms_per_call(device, fn, reps=reps)
    peak = lambda: (torch.cuda.max_memory_allocated() / 2**30 if cuda
                    else float("nan"))
    strip = write_gmsh(make_strip_mesh_2d(nx, ny),
                       os.path.join(tmp, "strip15.msh"))
    tri = write_gmsh(make_strip_mesh_2d(nx, ny, geom="triangle"),
                     os.path.join(tmp, "strip15_tri.msh"))
    base = {"material_file": TACOT_DECK, "order": 1, "dt": 0.1,
            "t_final": 0.1, "bdr_attr_top": 3, "probe_x": 0.00125,
            "newton_print_level": 0, "save_paraview": False,
            "output_every": 1}
    out = {}
    init_rank(0, 1, os.path.join(tmp, "store15"), device=device)
    try:
        mesh = make_device_mesh(1, device=device)
        out["backend"] = dist.get_backend()

        # -- 15a. the first Newton systems of case 2.1 (SEB) and case 1 ------
        # the residuals of the SEB system; the directions of case 1's, at
        # rtol 1e-13 (the point-block GMRES, the single-device one too,
        # stops 3.9e-7 from splu in p at rtol 1e-12 on case 1's system and
        # 1.9e-7 on the SEB system; 2.6e-8 on case 1's at 1e-13)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        a = {}
        for system, solve_it in (("case 2.1 (SEB)", False),
                                 ("case 1", True)):
            if solve_it:
                c = ablation_case1.Case1(
                    {**base, "mesh_file": strip,
                     "output_path": os.path.join(tmp, "c1_15a_sys")},
                    device, torch.float64)
                bc, seb = None, None
            else:
                c = ablation_case2_1.Case21(
                    {**base, "mesh_file": strip,
                     "boundary_conditions_file": SCHEDULE_C21,
                     "output_path": os.path.join(tmp, "c21_15a")}, device,
                    torch.float64)
            T, p = c.initial_fields()
            X = c.initial_state().extent
            To, po = c.ops.values_at_qp(T), c.ops.values_at_qp(p)
            if solve_it:
                T, p = c.enforce_bc(T, p, ablation_case1.evaluate_schedule(
                    c.schedule, c.dt))
                R = c.residual(T, p, To, po, X, c.dt)
                d_lu = c.host_lu(c.sys.element_jacobians(
                    T, p, To, po, X, c.dt)).solve(-R)
            else:
                bc, branch = c.boundary(c.dt)
                seb = c.seb(branch)
                T, p = c.enforce_bc(T, p, bc, c.dt)
                R = c.residual(T, p, To, po, X, c.dt, bc, branch)
            n = c.n
            sysrec = {"dofs": 2 * n}
            for name, cls, dofpart in classes:
                nw = cls(c.sys, mesh, c.ess_T, c.ess, seb=seb)
                slabs = class_slabs(nw, dofpart, To, po, X)
                Rg, fac, solve, glob, res_fn, prep_fn, y = newton_pieces(
                    nw, dofpart, T, p, slabs, c.dt, bc)
                err_R = rel_max(Rg, R)
                rec = {"residual_rel": err_R, "residual_ms": ms(res_fn),
                       "prepare_ms": ms(prep_fn),
                       "matvec_ms": ms(lambda: nw.matvec(fac[0], y))}
                if dofpart:
                    rec["per_device_floats"] = nw.per_device_floats()
                msg = ""
                if solve_it:
                    res, solve_s = timed(lambda: solve(fac, rtol))
                    dx = glob(res.x)
                    err_d = max(rel_max(dx[:n], d_lu[:n]),
                                rel_max(dx[n:], d_lu[n:]))
                    rec.update(direction_rel_vs_splu=err_d,
                               gmres_inner_iters=res.inner_iters,
                               gmres_cycles=res.iters,
                               converged=res.converged, solve_s=solve_s)
                    msg = (f"; direction vs splu {err_d:.3e} per field (tol "
                           f"1e-7), GMRES {res.inner_iters} iterations "
                           f"({res.iters} cycles) in {solve_s:.3f} s")
                    assert err_d <= 1e-7 and res.converged, rec
                sysrec[name] = rec
                log(f"phase 15a: {name}, {2 * n} DOFs, {system} step 1: "
                    f"residual vs single device {err_R:.3e} (tol 1e-12)"
                    f"{msg}; ms per residual {rec['residual_ms']:.2f}, "
                    f"prepare {rec['prepare_ms']:.2f}, matvec "
                    f"{rec['matvec_ms']:.3f}"
                    + (f"; per-rank floats {rec['per_device_floats']}"
                       if dofpart else ""))
                assert err_R <= 1e-12, rec
                del nw, slabs, fac
            c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                      + ("newton", "total")}, 0.0)
            a[system] = sysrec
            del c, R
        a["peak_mem_gib"] = peak()
        out["15a_newton_systems"] = a

        # -- 15a. one driver step with each option ---------------------------
        steps = []
        for label, run, cfg, first, key in (
                ("ablation_case1 dof_partition: 1", ablation_case1.run,
                 {**base, "mesh_file": strip, "dof_partition": 1,
                  "output_path": os.path.join(tmp, "c1_15a")}, first_c1,
                 "m_dot_g"),
                ("ablation_case2_2 sharding_devices: 1", ablation_case2_2.run,
                 {**base, "mesh_file": tri, "bdr_attr_bottom": 1,
                  "boundary_conditions_file": SCHEDULE_C21,
                  "sharding_devices": 1,
                  "output_path": os.path.join(tmp, "c22_15a")}, first_c22,
                 "p")):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            r, secs = timed(lambda: run(cfg, device=device))
            assert not any(counts().values()), counts()
            got = first_step_rows(cfg["output_path"], r)
            dT = max(abs(g - w) / abs(w) for g, w in zip(got["T"],
                                                         first["T"]))
            gp = got["p"] if key == "p" else [got["m_dot_g"]]
            wp = first["p"] if key == "p" else [first["m_dot_g"]]
            dp = max(abs(g - w) / abs(w) for g, w in zip(gp, wp))
            st = {"driver": label, "s_per_step": r["timing"][0]["total"],
                  "run_s": secs, "split_s": split_median(r["timing"]),
                  "newton_iters": r["newton_iters"],
                  "krylov_iters": r["krylov_iters"], "T_rel": dT,
                  f"{key}_rel": dp, "peak_mem_gib": peak()}
            steps.append(st)
            log(f"phase 15a: {label}: 1 step {st['s_per_step']:.3f} s "
                f"(split {json.dumps(st['split_s'])}); linear solves "
                f"{r['newton_iters']} (host LU {first['newton']}), GMRES "
                f"iterations {r['krylov_iters']}; vs the host-LU run's "
                f"first-step rows: T {dT:.3e} (tol 1e-6), {key} {dp:.3e} "
                f"(tol 1e-8)")
            assert r["newton_iters"] == [first["newton"]], r["newton_iters"]
            assert dT <= 1e-6 and dp <= 1e-8, (dT, dp)
        out["15a_driver_steps"] = steps

        # -- 15b. the refined strip: residual, prepare, one matvec ------------
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        c = ablation_case1.Case1(
            {**base, "mesh_file": strip, "serial_ref_levels": ref_levels,
             "output_path": os.path.join(tmp, "c1_15b")}, device,
            torch.float64)
        T, p = c.initial_fields()
        X = c.initial_state().extent
        To, po = c.ops.values_at_qp(T), c.ops.values_at_qp(p)
        T, p = c.enforce_bc(T, p, ablation_case1.evaluate_schedule(
            c.schedule, c.dt))
        n = c.n
        R = c.residual(T, p, To, po, X, c.dt)
        bks = BlockNewtonKrylov(c.fes.element_dofs, n, c.ess, c.ess,
                                device=device)
        single_prepare = lambda: bks.prepare(c.sys.element_jacobians(
            T, p, To, po, X, c.dt))
        Je_ref, pb_ref, s_ref = single_prepare()
        yv = torch.as_tensor(np.random.default_rng(15).standard_normal(
            2 * n), device=device)
        single_mv = lambda: bks._scatter(torch.einsum(
            "eij,ej->ei", Je_ref, bks._gather(yv)))
        mv_ref = single_mv()
        b = {"dofs": 2 * n, "single_device_ms": {
            "residual": ms(lambda: c.residual(T, p, To, po, X, c.dt)),
            "prepare": ms(single_prepare), "matvec": ms(single_mv)}}
        for name, cls, dofpart in classes:
            nw = cls(c.sys, mesh, c.ess, c.ess)
            slabs = class_slabs(nw, dofpart, To, po, X)
            Rg, fac, _, glob, res_fn, prep_fn, _ = newton_pieces(
                nw, dofpart, T, p, slabs, c.dt)
            Je_s, pb, s = fac
            if dofpart:
                # one rank owns every DOF, in order: the owned slabs are
                # the single-device layout
                pb = pb.T
                y = nw.to_dist2(yv[:n], yv[n:])
                mv = glob(nw.matvec(Je_s, y))
                want_mv = torch.where(bks.mask2, yv, mv_ref)
            else:
                y, want_mv = yv, mv_ref
                mv = nw.matvec(Je_s, y)
            errs = {"residual": rel_max(Rg, R),
                    "Je_s": rel_max(Je_s[:Je_ref.shape[0]], Je_ref),
                    "pb": rel_max(pb, pb_ref), "s": rel_max(s, s_ref),
                    "matvec": rel_max(mv, want_mv)}
            rec = {"max_rel_err": errs, "residual_ms": ms(res_fn),
                   "prepare_ms": ms(prep_fn),
                   "matvec_ms": ms(lambda: nw.matvec(Je_s, y))}
            if dofpart:
                rec["per_device_floats"] = nw.per_device_floats()
            b[name] = rec
            log(f"phase 15b: {name}, {2 * n} DOFs: vs the single-device "
                f"path {json.dumps({k: f'{v:.3e}' for k, v in errs.items()})}"
                f" (tol 1e-12); ms per residual {rec['residual_ms']:.2f} "
                f"(single {b['single_device_ms']['residual']:.2f}), prepare "
                f"{rec['prepare_ms']:.2f} "
                f"({b['single_device_ms']['prepare']:.2f}), matvec "
                f"{rec['matvec_ms']:.3f} "
                f"({b['single_device_ms']['matvec']:.3f})")
            assert max(errs.values()) <= 1e-12, errs
            del nw, slabs, fac, Je_s
        b["peak_mem_gib"] = peak()
        log(f"phase 15b: peak device memory {b['peak_mem_gib']:.3f} GiB")
        out["15b_refined"] = b
        c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
                  + ("newton", "total")}, 0.0)
        del c, bks, Je_ref
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    return out


def ablation_gloo_rank(n_devices, device, ckpt):
    """A rank of phase 15c: the ablation sections of the dry run
    (``entry.dryrun_ablation_rank``), then a ``save_sharded`` /
    ``load_sharded`` round trip of a ``DofPartitionedAblationNewton``'s
    state (its two-field slab and packed old-state slabs) into ``ckpt``;
    returns the dry run's record and whether every loaded slab equals the
    saved one bit for bit."""
    from cmfem_tpu_torch.core import make_cartesian_mesh_2d
    from cmfem_tpu_torch.entry import dryrun_ablation_rank
    from cmfem_tpu_torch.io.checkpoint import load_sharded, save_sharded
    from cmfem_tpu_torch.parallel import (DofPartitionedAblationNewton,
                                          make_device_mesh)
    from cmfem_tpu_torch.physics.ablation import AblationState, AblationSystem
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    t0 = time.perf_counter()
    out = {"dryrun": dryrun_ablation_rank(n_devices, device, TACOT_DECK)}
    t1 = time.perf_counter()
    mesh = make_device_mesh(n_devices, device=device)
    dev = mesh.device
    fes = FESpace(make_cartesian_mesh_2d(3, 8, sx=0.0025, sy=0.05), 1)
    ops = SpaceOps(fes, quad_order=4, device=dev, dtype=torch.float64)
    sys_ = AblationSystem(ops, TacotMaterial.load_yaml(TACOT_DECK),
                          top_attr=3)
    top = fes.boundary_dofs([3])
    dn = DofPartitionedAblationNewton(sys_, mesh, top, top)
    gen = np.random.default_rng(15)
    T = torch.as_tensor(300.0 + 900.0 * gen.random(fes.nscalar), device=dev)
    p = torch.as_tensor(1e5 * (1.0 + gen.random(fes.nscalar)), device=dev)
    X = AblationState.initial(sys_.ne, sys_.nq, sys_.mat, device=dev).extent
    saved = {"y": dn.to_dist2(T, p),
             "To": dn.pack_elem(ops.values_at_qp(T), "dup"),
             "po": dn.pack_elem(ops.values_at_qp(p), "dup"),
             "Xo": dn.pack_elem(X + 0.5, "dup")}
    save_sharded(ckpt, 15, 1.5, saved)
    step, t, loaded = load_sharded(ckpt, device=dev)
    out.update(rank=mesh.rank, device=str(dev), step=step, time=t,
               equal={k: bool(torch.equal(v, loaded[k]))
                      and loaded[k].device == v.device
                      for k, v in saved.items()},
               dryrun_s=t1 - t0, checkpoint_s=time.perf_counter() - t1)
    return out


def run_ablation_gloo_on_card(device, tmp, world=2, timeout=180):
    """Phase 15c: ``world`` gloo ranks on the one card (only all_reduce and
    all_gather run: gloo carries them on CUDA tensors) through
    ``ablation_gloo_rank``: the dry run's ablation sections (two
    element-sharded iterates, the DOF-partitioned one against them, the
    case-2.2 iterate on a receded mesh, to 1e-6) and the checkpoint round
    trip, bit for bit; then loading the checkpoint in this process (world
    size 1) must be refused in the words "world size".  Any error fails
    the phase."""
    from cmfem_tpu_torch.io.checkpoint import load_sharded
    from cmfem_tpu_torch.parallel import spawn_ranks

    kind = torch.device(device).type
    ckpt = os.path.join(tmp, "ckpt15c")
    ranks, secs = timed(lambda: spawn_ranks(
        ablation_gloo_rank, world, (world, kind, ckpt), device=device,
        backend="gloo", timeout=timeout))
    try:
        load_sharded(ckpt)
        refused = None
    except ValueError as e:
        refused = str(e)
    d0 = ranks[0]["dryrun"]
    rec = {"world": world, "devices": [r["device"] for r in ranks],
           "spawn_s": secs, "dryrun_s": ranks[0]["dryrun_s"],
           "checkpoint_s": ranks[0]["checkpoint_s"], "dryrun": d0,
           "checkpoint_equal": [r["equal"] for r in ranks],
           "checkpoint_step_time": [ranks[0]["step"], ranks[0]["time"]],
           "world_size_refusal": refused}
    log(f"phase 15c: {world} gloo ranks on {rec['devices']}: sharded "
        f"|R| {d0['ablation_sharded_r0']:.4e} -> "
        f"{d0['ablation_sharded_r1']:.4e}; DOF-partitioned vs sharded "
        f"{d0['ablation_dofpart_rel']:.3e}, case 2.2 "
        f"{d0['ablation_case22_rel']:.3e} (tol 1e-6); checkpoint round trip "
        f"bit for bit {rec['checkpoint_equal']}; world size 1 refused: "
        f"{refused!r}; {secs:.1f} s (dry run {rec['dryrun_s']:.1f} s, "
        f"checkpoint {rec['checkpoint_s']:.1f} s in the ranks)")
    assert all(r["dryrun"] == d0 for r in ranks), ranks
    assert all(all(r["equal"].values()) for r in ranks), ranks
    assert all((r["step"], r["time"]) == (15, 1.5) for r in ranks)
    assert refused is not None and "world size" in refused, refused
    return rec


# the JAX study's line-MG and point-block inner iterations at refine 0, on
# the reference deck and mesh (artifacts_blocksolve_refinement.partial.json;
# heating, char_cooldown): the port's run on the synthetic deck, so these
# are printed beside its counts, not held to them
JAX_16A_REFINE0 = {"linemg": (10, 11), "pointblock": (358, 299)}


def run_scripts(device, tmp, nx=11, ny=239, n_dots=12):
    """Phase 16: the study scripts of ``cmfem_tpu_torch.scripts`` through
    their entry points, float64 unless named: (a) the refinement study at
    refine 0 (both states, line MG and the point blocks), (b) ``fullrun
    case1 --eager --t-final 0.3`` through the module's ``main`` (the
    artifact's ``sane``), (c) the compensated-dot CG at N = ``n_dots``
    (float64 oracle on the CPU, float32 on ``device``).  Returns the
    ``scripts`` record.  The sizes are arguments so that the control flow
    can be rehearsed small on a CPU (``tests/test_torch_scripts_phase16.py``).
    """
    from cmfem_tpu_torch.scripts import (blocksolve_refinement,
                                         compensated_dots, fullrun)

    cuda = torch.device(device).type == "cuda"
    rec = {}
    # -- 16a. the refinement study at refine 0
    t0 = time.perf_counter()
    # one untimed pass: the study launches nothing but its solves
    study = blocksolve_refinement.run_study(
        (0,), device=device, out_dir=tmp, nx=nx, ny=ny, timed=False)
    lv = study["levels"][0]
    for name, st in lv["states"].items():
        for pc in ("linemg", "pointblock"):
            r = st[pc]
            log(f"phase 16a: refine 0 ({lv['ndofs_tp']} DOFs) {name} "
                f"({st['branch']}) {pc}: converged={r['converged']}, "
                f"{r['inner_iters']} inner iterations ({r['cycles']} cycles;"
                f" the JAX study's on the reference deck "
                f"{JAX_16A_REFINE0[pc]}), prepare+solve "
                f"{r['prepare_plus_solve_s']:.3f} s, rel residual "
                f"{r['rel_residual']:.3e}, line launches "
                f"{r['launches_factor']}/{r['launches_solve']}")
            assert r["converged"], (name, pc)
            if pc == "pointblock":
                assert r["launches_solve"] == 0, r
            elif cuda:
                assert r["launches_factor"] > 0 and r["launches_solve"] > 0, r
    log(f"phase 16a: line-MG levels {lv['nxs']} (NY = {lv['NY']}); peak "
        f"{lv['peak_gib']} GiB; {time.perf_counter() - t0:.1f} s")
    rec["refinement_refine0"] = lv
    # -- 16b. fullrun case 1, 3 steps through main
    t0 = time.perf_counter()
    art_path = os.path.join(tmp, "fullrun_case1.json")
    rc = fullrun.main(["case1", "--eager", "--t-final", "0.3", "--out-dir",
                       os.path.join(tmp, "fr1"), "--artifact", art_path]
                      + ([] if cuda else ["--cpu"]))
    with open(art_path) as f:
        art = json.load(f)
    log(f"phase 16b: fullrun case1 --eager --t-final 0.3: rc {rc}, sane "
        f"{art['sane']}, {art['n_steps']} steps, {art['ms_per_step']} ms per "
        f"step, T {art['T_min']}..{art['T_max']} K, m_dot_g peak "
        f"{art['mdot_g_peak']}; {time.perf_counter() - t0:.1f} s")
    assert rc == 0 and art["sane"] and art["n_steps"] == 3, art
    rec["fullrun_case1"] = art
    # -- 16c. compensated dots
    t0 = time.perf_counter()
    cd = compensated_dots.run(n_dots, torch.device(device))
    log(f"phase 16c: compensated dots N = {n_dots} ({cd['ndofs']} DOFs): "
        f"oracle {cd['oracle_iters']} iterations; float32 plain "
        f"{cd['plain_vdot']}, Neumaier {cd['neumaier']}; "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("plain_vdot", "neumaier"):
        assert cd[name]["rel_l2_vs_f64_oracle"] <= 1e-4, cd
    rec["compensated_dots"] = cd
    return rec


def main():
    t_start = time.perf_counter()
    # -- 1. checks --------------------------------------------------------
    dev = cmfem_tpu_torch.require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kmods = (ksum, kbtdb, kz, klmg)
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kmods)) as pool:
        list(pool.map(lambda kmod: kmod.build(), kmods))
    log(f"phase 1: {len(kmods)} kernel libraries built in parallel, "
        f"{time.perf_counter() - t_build:.2f} s")
    for kmod in kmods:
        secs, nvcc_log = kbuild.build_info(kmod.LIB_NAME)
        log(f"phase 1: kernel library {kmod.LIB_NAME} built/loaded in "
            f"{secs:.2f} s")
        for line in nvcc_log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
    lane = lane_kernel_resources(kbuild.build_info(ksum.LIB_NAME)[1])
    log(f"phase 1: sumfact_lane_kernel<T, N = p+1> (registers, spill bytes "
        f"stored + loaded): {lane}")
    assert len(lane) == 8 and not any(s for _, s in lane.values()), lane
    tiled = kbtdb.tiled_kernel_resources()
    tiled_geo = {f"{'float' if size == 4 else 'double'} nd={nd}": (
        geo.E, geo.THREADS, geo.STAGES, kbtdb.tiled_blocks_per_sm(nd, size))
        for size in (4, 8) for nd in kbtdb.TILED_ND
        for geo in [kbtdb.tile_geometry(nd, nd, size)]}
    log(f"phase 1: btdb_tiled_kernel (registers, spill bytes stored + "
        f"loaded): {tiled}; (elements per block, threads, ring stages, "
        f"resident blocks per SM): {tiled_geo}")
    assert len(tiled) == 12, tiled
    assert not any(s for k, (_, s) in tiled.items()
                   if k.startswith("float") and k.endswith("wide")), tiled

    # -- 2 and 8a. sum-factorization and z-chain kernels against their plain
    # versions ---------------------------------------------------------------
    gen = np.random.default_rng(0)
    for n in ((3, 4, 5), (6, 6, 6), (7, 5, 9)):
        for order in (1, 2, 3, 4):
            for dtype in (torch.float64, F32):
                cases = [("uniform", cdr, False), ("kappa(z)", vc, False),
                         ("distorted", vc, True)]
                for name, form, distorted in cases:
                    op = sumfact_operator(n, order, form, dev, dtype,
                                          distorted)
                    assert op.compressed and op.z_periodic == (
                        name == "uniform"), (n, order, name)
                    u = torch.as_tensor(gen.standard_normal(op.ndofs),
                                        dtype=dtype, device=dev)
                    for periodic in (True, False) if op.z_periodic \
                            else (False,):
                        fk, Dk = op.bind_kernel(use_periodic=periodic)
                        fp, Dp = op.bind(use_periodic=periodic)
                        err, _ = compare(lambda v: fk(v, Dk),
                                         lambda v: fp(v, Dp), u)
                        ok = err <= TOL[dtype]
                        what = (f"n={n} p={order} {str(dtype)[6:]} {name} "
                                f"{'z-periodic' if periodic else 'full D'}")
                        log(f"phase 2: {what}: max|k-p|/max|p| = {err:.3e} "
                            f"(tol {TOL[dtype]:.0e}) "
                            f"{'ok' if ok else 'FAIL'}")
                        assert ok, (n, order, dtype, name, periodic, err)
                        # B4: the z-chain kernel on the same x/y fields,
                        # then the whole bind_zchain apply against bind()
                        fz, Dz = op.bind_zchain(use_periodic=periodic)
                        zargs = (Dz, op.tab, op.Az, op.DAz, periodic)
                        before = kz.launches
                        err_t, _ = compare(
                            stacked(lambda *T: kz.zchain_apply(*T, *zargs)),
                            stacked(lambda *T: kz.zchain_plain(
                                *T, Dz, op.Az, op.DAz, periodic)),
                            *op.xy_fields(u))
                        err_z, _ = compare(lambda v: fz(v, Dz),
                                           lambda v: fp(v, Dp), u)
                        assert kz.launches == before + 2
                        ok = max(err_t, err_z) <= TOL[dtype]
                        log(f"phase 8a: {what}: z-chain kernel vs plain "
                            f"{err_t:.3e}, bind_zchain vs bind() {err_z:.3e} "
                            f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
                        assert ok, (n, order, dtype, name, periodic, err_t,
                                    err_z)

    # -- 3. B^T D B kernel against its plain version, every shape of
    # KERNEL_SHAPES, from operators on triangles, quads, tets and hexes ------
    b1_shapes = {}
    for geom, dim, mesh in (
            ("hex", 3, make_cartesian_mesh_3d(3, 4, 5)),
            ("quad", 2, make_cartesian_mesh_2d(7, 5)),
            ("triangle", 2, make_cartesian_mesh_2d(7, 5, geom="triangle")),
            ("tet", 3, make_tet_mesh(2))):
        for order in (1, 2, 3, 4):
            # q1 = p + 1, p + 2 and 3 points per axis
            for quad_order in (2 * order, 2 * order + 2, 4):
                ops = SpaceOps(FESpace(mesh, order), quad_order=quad_order,
                               device=dev)
                shape = (dim + 1, ops.B.shape[1], ops.B.shape[0])
                if shape in b1_shapes:
                    continue
                form = vc(BilinearForm(ops), dim)
                data = form.assemble()
                u64 = torch.as_tensor(gen.standard_normal(ops.fes.nscalar),
                                      device=dev)
                y_ref = form.apply(data, u64)
                errs = []
                for dtype in (torch.float64, F32):
                    pa = PAOperator(ops, data, dtype=dtype)
                    assert pa.path == "cuda-btdb", pa.path
                    u_eT = torch.as_tensor(gen.standard_normal(
                        pa.eldofs_T.shape), dtype=dtype, device=dev)
                    before = kbtdb.launches
                    err, _ = compare(lambda v: kbtdb.btdb_apply(
                                         pa.BG, v, pa.Dflat, pa.BG_stream),
                                     lambda v: kbtdb.btdb_plain(pa.BG, v,
                                                                pa.Dflat),
                                     u_eT)
                    err_op = rel_err(pa(u64.to(dtype)).double(), y_ref)
                    assert kbtdb.launches == before + 2
                    # the plain version, asked for by name, moves no count
                    pp = PAOperator(ops, data, dtype=dtype, use_kernel=False)
                    err_pp = rel_err(pp(u64.to(dtype)).double(), y_ref)
                    assert pp.path == "plain-btdb" and pp.BG_stream is None
                    assert kbtdb.launches == before + 2
                    ok = max(err, err_op, err_pp) <= TOL[dtype]
                    log(f"phase 3: {geom} p={order} q={quad_order} "
                        f"(m, nd, nq) = {shape} {str(dtype)[6:]}: "
                        f"max|k-p|/max|p| = {err:.3e}, PA apply vs "
                        f"BilinearForm.apply {err_op:.3e} (use_kernel=False "
                        f"{err_pp:.3e}; tol {TOL[dtype]:.0e}) "
                        f"{'ok' if ok else 'FAIL'}")
                    assert ok, (geom, order, quad_order, dtype, err, err_op,
                                err_pp)
                    errs.append(err)
                b1_shapes[shape] = {"geom": geom, "order": order,
                                    "quad_order": quad_order,
                                    "max_rel_err_f64_f32": errs}
    assert set(b1_shapes) == set(kbtdb.KERNEL_SHAPES), \
        set(kbtdb.KERNEL_SHAPES) ^ set(b1_shapes)
    # the lattice operator at a rule with p + 2 points per axis
    ops = SpaceOps(FESpace(make_cartesian_mesh_3d(3, 4, 5), 2), quad_order=7,
                   device=dev)
    spa = StructuredPAOperator(ops, BilinearForm(ops).add_mass(1.0)
                               .assemble(), StructuredGrid3D(3, 4, 5, 2))
    assert spa.path == "cuda-btdb" and spa.BG_stream is not None
    try:  # a shape outside the set (an order-5 quad) is refused
        kbtdb.btdb_apply(*(torch.zeros(s, device=dev) for s in
                           ((3 * 36, 36), (36, 5), (9, 36, 5))))
        raise AssertionError("btdb_apply took a shape it has no kernel for")
    except ValueError as e:
        refusal = str(e)
    assert "(3, 36, 36) is not one of" in refusal, refusal
    log(f"phase 3: {len(b1_shapes)} shapes through the kernel; "
        f"StructuredPAOperator at q1 = p + 2 -> {spa.path}; outside the "
        f"set: {refusal[:60]}...")
    del spa, ops

    # the shapes added in this slice timed alone at 110,592 elements
    # (the 48^3 element count), float32, kernel and plain version
    b1_new = time_new_btdb_shapes(dev, 110_592)

    # -- 4. slice 1's main path -----------------------------------------------
    (step, (u0, D)), setup_s = timed(lambda: entry(n=48, order=2, dtype=F32))
    op = step.op
    log(f"phase 4: entry(n=48, order=2) ndofs={op.ndofs} setup {setup_s:.2f} s"
        f"; best_bind -> {step.path}; compressed={op.compressed} "
        f"z_periodic={op.z_periodic} periodic={op.periodic}")
    assert op.ndofs == 912_673
    assert step.path == "cuda-sumfact-zperiodic", step.path
    # a first step pays one-time costs (cuBLAS handles, allocator growth)
    _, first_step_s = timed(lambda: step(u0, D))
    res, step_s, launched = check_step(step, u0, (D,), "phase 4 entry")
    b2_launches = launched["sumfact"]
    assert b2_launches > 0 and launched["sumfact_fulld"] == 0, launched
    fnp, Dp = op.bind(use_periodic=True)
    res_p, plain_step_s = timed(lambda: step.solve(u0, fnp, Dp))
    dx2 = rel2(res.x, res_p.x)
    log(f"phase 4: first step {first_step_s:.4f} s; plain-version step "
        f"{plain_step_s:.4f} s, arnoldi={res_p.inner_iters} converged="
        f"{res_p.converged}; kernel vs plain solution 2-norm rel {dx2:.3e}")
    assert res_p.converged and dx2 <= 1e-4, dx2
    (sstep, (su0, sD)), spd_setup_s = timed(
        lambda: spd_step(n=48, order=2, dtype=F32))
    reset_counts()
    sres, spd_s = timed(lambda: sstep(su0, sD))
    log(f"phase 4: SPD CG step via {sstep.path}: setup {spd_setup_s:.2f} s, "
        f"step {spd_s:.4f} s, iters={sres.iters} converged={sres.converged} "
        f"rel_residual={sres.rel_residual:.3e}; launches {counts()}")
    assert sstep.path == "cuda-sumfact-zperiodic", sstep.path
    assert sres.converged and torch.isfinite(sres.x).all()
    assert ksum.launches > 0
    b2_launches += ksum.launches
    # B2 timing at the main-path shape, then free slice 1's arrays
    u = torch.as_tensor(gen.standard_normal(op.ndofs), dtype=F32, device=dev)
    fk, Dk = op.bind_kernel(use_periodic=True)
    b2_err, b2_abs = compare(lambda v: fk(v, Dk), lambda v: fnp(v, Dp), u)
    assert b2_err <= TOL[F32], b2_err
    b2_k, b2_p = in_turns(lambda: fk(u, Dk), lambda: fnp(u, Dp), graph=True)
    b2_call = median_ms(lambda: fk(u, Dk))
    b2_bound = bound(nbytes(Dk, u, u), sumfact_flops(op))
    log(f"phase 4: 48^3 z-periodic kernel vs plain: max|k-p|/max|p| = "
        f"{b2_err:.3e}, max|k-p| = {b2_abs:.3e}; device ms per apply (two "
        f"rounds): kernel {b2_k}, plain {b2_p}; one kernel call with its "
        f"host enqueue {b2_call:.4f} ms; bound {b2_bound}")
    del step, sstep, op, D, Dp, Dk, sD, res, res_p, sres, fk, fnp
    torch.cuda.empty_cache()

    # -- 5. slice 2: three operators on the variable-coefficient form --------
    torch.cuda.reset_peak_memory_stats()
    steps, setups = {}, {}
    for name in OPERATORS:
        steps[name], setups[name] = timed(
            lambda: vc_entry(n=48, order=2, operator=name, dtype=F32))
    sf_step, (u0, sD) = steps["sumfact"]
    spa_step, (_, Dflat_s) = steps["structured-pa"]
    pa_step, (pu0, Dflat_e, eldofs_T) = steps["pa"]
    sop = sf_step.op
    log(f"phase 5: vc_entry(n=48, order=2) setup s: {setups}; sumfact "
        f"compressed={sop.compressed} z_periodic={sop.z_periodic}; paths "
        f"{[steps[k][0].path for k in OPERATORS]}")
    assert sop.compressed and not sop.z_periodic
    assert sf_step.path == "cuda-sumfact-fullD", sf_step.path
    assert spa_step.path == pa_step.path == "cuda-btdb"
    lat = pa_step.lat
    assert torch.equal(pu0, u0[lat])
    to_lat = lambda x: torch.zeros_like(x).index_copy_(0, lat, x)
    u = torch.as_tensor(gen.standard_normal(sop.ndofs), dtype=F32, device=dev)
    y_sf = sf_step.fn(u, sD)
    y_spa = spa_step.fn(u, Dflat_s)
    y_pa = to_lat(pa_step.fn(u[lat], Dflat_e, eldofs_T))
    torch.cuda.synchronize()
    e_spa, e_pa = rel_err(y_spa, y_sf), rel_err(y_pa, y_sf)
    log(f"phase 5: one apply, structured-PA (B1) vs full-D sumfact: "
        f"max|d|/max|y| = {e_spa:.3e}; PA (B1, entity numbering) vs sumfact:"
        f" {e_pa:.3e} (tol 1e-5)")
    assert e_spa <= 1e-5 and e_pa <= 1e-5, (e_spa, e_pa)
    results, step_times, vc_launches = {}, {}, {}
    for name in OPERATORS:
        st, (su, *arrays) = steps[name]
        timed(lambda: st(su, *arrays))  # warm
        res, step_times[name], vc_launches[name] = check_step(
            st, su, arrays, f"phase 5 {name}")
        results[name] = res.x if st.lat is None else to_lat(res.x)
    assert vc_launches["sumfact"]["sumfact_fulld"] > 0
    assert vc_launches["structured-pa"]["btdb"] > 0
    assert vc_launches["pa"]["btdb"] > 0
    d_spa = rel2(results["structured-pa"], results["sumfact"])
    d_pa = rel2(results["pa"], results["sumfact"])
    log(f"phase 5: solutions vs sumfact, 2-norm rel: structured-pa "
        f"{d_spa:.3e}, pa {d_pa:.3e} (tol 1e-4)")
    assert d_spa <= 1e-4 and d_pa <= 1e-4, (d_spa, d_pa)
    vc_peak = torch.cuda.max_memory_allocated()

    # B1 and B3 timings at the 48^3 shapes
    spa_op = spa_step.op
    grid, BG, BGs = spa_op.grid, spa_op.BG, spa_op.BG_stream
    assert BGs is not None  # the operator packed BG for the tiled design
    u_eT = grid.gather(u)
    b1_err, b1_abs = compare(lambda v: kbtdb.btdb_apply(BG, v, Dflat_s, BGs),
                             lambda v: kbtdb.btdb_plain(BG, v, Dflat_s), u_eT)
    assert b1_err <= TOL[F32], b1_err
    b1_k, b1_p = in_turns(lambda: kbtdb.btdb_apply(BG, u_eT, Dflat_s, BGs),
                          lambda: kbtdb.btdb_plain(BG, u_eT, Dflat_s),
                          graph=True)
    b1_call = median_ms(lambda: kbtdb.btdb_apply(BG, u_eT, Dflat_s, BGs))
    b1_bound = bound(nbytes(BG, u_eT, Dflat_s, u_eT), btdb_flops(BG, Dflat_s))
    # the same arrays through btdb_plain
    spa_plain, _ = StructuredPAOperator.from_arrays(
        Dflat_s, BG, grid, device=dev, dtype=F32, use_kernel=False).bind()
    b1g_k, b1g_p = in_turns(lambda: spa_step.fn(u, Dflat_s),
                            lambda: spa_plain(u, Dflat_s))
    ue = u[lat]
    pa_k = median_ms(lambda: pa_step.fn(ue, Dflat_e, eldofs_T))
    log(f"phase 7: B1 48^3 p=2 f32 (ne={u_eT.shape[1]}): max|k-p|/max|p| = "
        f"{b1_err:.3e}, max|k-p| = {b1_abs:.3e}; bound {b1_bound}; device "
        f"ms per call kernel {b1_k}, btdb_plain {b1_p}; one kernel call "
        f"{b1_call:.4f} ms; median ms of one call with lattice gather+scatter: kernel {b1g_k}, "
        f"plain {b1g_p}; PA entity gather+index_add_ with kernel {pa_k:.4f}")
    fk, Dk = sop.bind_kernel()
    fp, Dp = sop.bind()
    b3_err, b3_abs = compare(lambda v: fk(v, Dk), lambda v: fp(v, Dp), u)
    assert b3_err <= TOL[F32], b3_err
    b3_k, b3_p = in_turns(lambda: fk(u, Dk), lambda: fp(u, Dp), graph=True)
    b3_call = median_ms(lambda: fk(u, Dk))
    b3_bound = bound(nbytes(Dk, u, u), sumfact_flops(sop))
    log(f"phase 7: full-D sumfact (B3 counterpart) 48^3 p=2 f32 on kappa(z)"
        f" D: max|k-p|/max|p| = {b3_err:.3e}, max|k-p| = {b3_abs:.3e}; "
        f"bound {b3_bound}; device ms per apply kernel {b3_k}, plain "
        f"{b3_p}; one kernel call {b3_call:.4f} ms")
    log(f"phase 7: vc GMRES step s {step_times}; setup s {setups}; peak "
        f"device memory in phase 5: {vc_peak / 2**30:.2f} GiB")
    del steps, sf_step, spa_step, pa_step, sop, sD, Dflat_s, Dflat_e, eldofs_T
    del results, u_eT, ue, fk, fp, Dk, Dp, BG, grid, spa_op, spa_plain
    torch.cuda.empty_cache()

    # -- 6. slice 2: StructuredMG ------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    mg_runs = {}
    mg_launches = 0
    for n in (24, 48):
        reset_counts()
        r = mg_solve(n=n, order=2, dtype=torch.float64)
        launched = counts()
        mg_runs[n] = r
        log(f"phase 6: mg_solve(n={n}, order=2) f64 MG-PCG: iters="
            f"{r.result.iters} converged={r.result.converged} rel_residual="
            f"{r.result.rel_residual:.3e} L2 error {r.l2_error:.6e}; fine "
            f"level {r.path}; setup {r.setup_s:.2f} s, solve "
            f"{r.solve_s:.4f} s; launches {launched}")
        assert r.result.converged and r.result.iters <= 20, r.result
        assert r.path == "cuda-sumfact-fullD", r.path
        assert launched["sumfact_fulld"] > 0, launched
        mg_launches += launched["sumfact_fulld"]
    # the fine level's float64 full-D launch at the main-path size, held
    # against the plain chain of the same operator
    fop = mg_runs[48].op
    fk, Dk = fop.bind_kernel()
    fp, Dp = fop.bind()
    u = torch.as_tensor(gen.standard_normal(fop.ndofs), dtype=torch.float64,
                        device=dev)
    mg_err, mg_abs = compare(lambda v: fk(v, Dk), lambda v: fp(v, Dp), u)
    log(f"phase 6: MG fine level (n=48, p=2, f64, {fop.ndofs} DOFs) full-D "
        f"kernel vs plain: max|k-p|/max|p| = {mg_err:.3e}, max|k-p| = "
        f"{mg_abs:.3e} (tol {TOL[torch.float64]:.0e})")
    assert mg_err <= TOL[torch.float64], mg_err
    del fop, fk, fp, Dk, Dp
    rate = math.log2(mg_runs[24].l2_error / mg_runs[48].l2_error)
    log(f"phase 6: L2 rate log2(e24/e48) = {rate:.3f} (>= 2.7)")
    assert rate >= 2.7, rate
    jac = mg_solve(n=48, order=2, dtype=torch.float64, precond="jacobi")
    log(f"phase 6: Jacobi-PCG n=48 f64: iters={jac.result.iters} converged="
        f"{jac.result.converged} rel_residual={jac.result.rel_residual:.3e} "
        f"L2 error {jac.l2_error:.6e}; setup {jac.setup_s:.2f} s, solve "
        f"{jac.solve_s:.4f} s (MG: {mg_runs[48].result.iters} iterations, "
        f"{mg_runs[48].solve_s:.4f} s)")
    r32 = mg_solve(n=48, order=2, dtype=F32)
    d32 = rel2(r32.result.x.double(), mg_runs[48].result.x)
    log(f"phase 6: MG-PCG n=48 f32: iters={r32.result.iters} converged="
        f"{r32.result.converged} stagnated={r32.result.stagnated} "
        f"rel_residual={r32.result.rel_residual:.3e}; vs f64 solution "
        f"2-norm rel {d32:.3e} (tol 1e-3); setup {r32.setup_s:.2f} s, solve "
        f"{r32.solve_s:.4f} s")
    assert torch.isfinite(r32.result.x).all() and d32 <= 1e-3, d32
    mg_peak = torch.cuda.max_memory_allocated()
    log(f"phase 7: peak device memory in phase 6: {mg_peak / 2**30:.2f} GiB;"
        f" wall so far {time.perf_counter() - t_start:.1f} s")

    # -- 8b. slice 3: the operator-apply sweep at orders 2-4 -------------------
    b1_launches = (vc_launches["structured-pa"]["btdb"]
                   + vc_launches["pa"]["btdb"])
    b3_launches = vc_launches["sumfact"]["sumfact_fulld"] + mg_launches
    b4_launches = 0
    sweep, b4 = {}, {}
    by_order = {"B1": {}, "B2": {}, "B3": {}}
    pa_alone = {}
    for order in (2, 3, 4):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        P, setup_s = timed(lambda: operator_paths(n=48, order=order,
                                                  dtype=F32))
        assert tuple(P.paths) == PATHS, list(P.paths)
        u = torch.as_tensor(gen.standard_normal(P.ndofs), dtype=F32,
                            device=dev)
        ys, launched = {}, {}
        for name, (fn, arrays) in P.paths.items():
            reset_counts()
            ys[name] = fn(u, *arrays)
            torch.cuda.synchronize()
            launched[name] = counts()
        peak = torch.cuda.max_memory_allocated()  # before any timing
        b1_launches += (launched["structured-pa"]["btdb"]
                        + launched["pa"]["btdb"])
        b2_launches += launched["sumfact-zfma-periodic"]["sumfact"]
        b3_launches += launched["sumfact-fused"]["sumfact_fulld"]
        b4_launches += (launched["sumfact-zchain"]["zchain"]
                        + launched["sumfact-zchain-periodic"]["zchain"])
        y_ref = ys["sumfact"]
        log(f"phase 8b: operator_paths(n=48, order={order}): {P.ndofs} DOFs,"
            f" setup {setup_s:.2f} s")
        for name, y in ys.items():
            err = rel_err(y, y_ref)
            moved = {k for k, v in launched[name].items() if v}
            log(f"phase 8b: p={order} {name}: max|y - y_sumfact|/max|y| = "
                f"{err:.3e} (tol 1e-5); launches {launched[name]}")
            assert torch.isfinite(y).all() and err <= 1e-5, (order, name, err)
            assert moved == PATH_COUNTERS[name], (order, name, moved)
        del ys
        ref_fn, ref_arrays = P.paths["sumfact"]
        ref_ms = []
        for name in PATHS[1:]:
            fn, arrays = P.paths[name]
            k, r = in_turns(lambda: fn(u, *arrays),
                            lambda: ref_fn(u, *ref_arrays), reps=20)
            sweep[order, name] = min(k)
            ref_ms += r
        sweep[order, "sumfact"] = min(ref_ms)
        for name in PATHS:
            log(f"phase 8b: p={order} {name}: median apply "
                f"{sweep[order, name]:.4f} ms, "
                f"{P.ndofs / sweep[order, name] / 1e3:.1f} MDOF/s")
        # the z-chain kernel alone on its x/y fields, full D and Dz
        sf = P.sumfact
        T = sf.xy_fields(u)
        for periodic in (False, True):
            _, Dk = sf.bind_zchain(use_periodic=periodic)
            zargs = (Dk, sf.tab, sf.Az, sf.DAz, periodic)
            err, err_abs = compare(
                stacked(lambda *T: kz.zchain_apply(*T, *zargs)),
                stacked(lambda *T: kz.zchain_plain(*T, Dk, sf.Az, sf.DAz,
                                                   periodic)), *T)
            assert err <= TOL[F32], (order, periodic, err)
            k, pl = in_turns(lambda: kz.zchain_apply(*T, *zargs),
                             lambda: kz.zchain_plain(*T, Dk, sf.Az, sf.DAz,
                                                     periodic), graph=True)
            call = median_ms(lambda: kz.zchain_apply(*T, *zargs), reps=20)
            bms, by = bound(nbytes(Dk, *T, *T), zchain_flops(sf))
            b4[order, periodic] = {"ms": min(k), "plain_ms": min(pl),
                                   "bound_ms": bms, "bound_by": by,
                                   "max_abs_err": err_abs, "call_ms": call}
            log(f"phase 8b: p={order} z-chain kernel alone "
                f"{'Dz' if periodic else 'full D'}: max|k-p|/max|p| = "
                f"{err:.3e}, max|k-p| = {err_abs:.3e}; device ms per call "
                f"kernel {k}, plain {pl}; one call with its host enqueue "
                f"{call:.4f} ms; bound {bms:.4f} ms ({by})")
        del T
        # the element-local kernel at this order (B2 on Dz, B3's launch on
        # full D) alone: device time beside the bound and the share of it
        for name, key in (("sumfact-zfma-periodic", "B2"),
                          ("sumfact-fused", "B3")):
            fn, arrays = P.paths[name]
            Dk = arrays[0]
            k = [graph_ms(lambda: fn(u, Dk)) for _ in range(2)]
            bnd = bound(nbytes(Dk, u, u), sumfact_flops(sf))
            by_order[key][f"p{order}"] = {
                "ms": min(k), "bound_ms": bnd[0], "bound_by": bnd[1],
                "share": bnd[0] / min(k)}
            log(f"phase 8b: p={order} {name} ({key}) device ms per call "
                f"{k}; bound {bnd[0]:.4f} ms ({bnd[1]}); share of the "
                f"bound {bnd[0] / min(k):.3f}")
        # the PA apply alone, in entity numbering: gather, B1, index_add_
        # (the sweep's "pa" also moves u and y between the numberings)
        pa_fn, pa_D, pa_el = P.pa.bind()
        assert P.pa.path == "cuda-btdb", P.pa.path
        ue = u[P.lat]
        k_pa = [graph_ms(lambda: pa_fn(ue, pa_D, pa_el)) for _ in range(2)]
        k_gather = graph_ms(lambda: ue[pa_el])
        y_eT = ue[pa_el]
        k_scatter = graph_ms(lambda: torch.zeros_like(ue).index_add_(
            0, pa_el.view(-1), y_eT.view(-1)))
        k_moves = graph_ms(lambda: torch.empty_like(u).index_copy_(
            0, P.lat, u[P.lat]))
        pa_alone[f"p{order}"] = {
            "ms": min(k_pa), "gather_ms": k_gather, "scatter_ms": k_scatter,
            "sweep_lattice_moves_ms": k_moves}
        log(f"phase 8b: p={order} PAOperator.bind() apply alone, entity "
            f"numbering, device ms per call {k_pa}; u[eldofs_T] alone "
            f"{k_gather:.4f}, index_add_ alone {k_scatter:.4f}; the sweep's "
            f"two lattice moves alone {k_moves:.4f}")
        del pa_fn, pa_D, pa_el, ue, y_eT
        if order > 2:  # order 2: phase 7
            spa = P.structured_pa
            u_eT = spa.grid.gather(u)
            BG, BGs, Dflat = spa.BG, spa.BG_stream, spa.Dflat
            assert BGs is not None
            err, err_abs = compare(
                lambda v: kbtdb.btdb_apply(BG, v, Dflat, BGs),
                lambda v: kbtdb.btdb_plain(BG, v, Dflat), u_eT)
            assert err <= TOL[F32], err
            k, pl = in_turns(lambda: kbtdb.btdb_apply(BG, u_eT, Dflat, BGs),
                             lambda: kbtdb.btdb_plain(BG, u_eT, Dflat),
                             graph=True)
            call = median_ms(lambda: kbtdb.btdb_apply(BG, u_eT, Dflat, BGs),
                             reps=20)
            bms, by = bound(nbytes(BG, u_eT, Dflat, u_eT),
                            btdb_flops(BG, Dflat))
            by_order["B1"][f"hex_p{order}"] = {
                "ms": min(k), "plain_ms": min(pl), "bound_ms": bms,
                "bound_by": by, "share": bms / min(k),
                "max_abs_err": err_abs, "call_ms": call}
            log(f"phase 8b: B1 at hex p={order} (ne={u_eT.shape[1]}): "
                f"max|k-p|/max|p| = {err:.3e}, max|k-p| = {err_abs:.3e}; "
                f"device ms per call kernel {k}, btdb_plain {pl}; one call "
                f"{call:.4f} ms; bound {bms:.4f} ms ({by}), share of the "
                f"bound {bms / min(k):.3f}")
            del spa, u_eT, BG, Dflat
        log(f"phase 8b: p={order} peak device memory of the setup and "
            f"the eight applies {peak / 2**30:.2f} GiB")
        del P, sf, u, fn, arrays, ref_fn, ref_arrays, Dk
    torch.cuda.empty_cache()

    # -- 8c. slice 3: BE steps at orders 3 and 4 through B4 and through B1 ---
    pa_steps = {}
    for order in (3, 4):
        for label, make, periodic, path in (
                ("vc_entry", vc_entry, False, "cuda-sumfact-fullD"),
                ("entry", entry, True, "cuda-sumfact-zperiodic")):
            (step, (u0, D)), setup_s = timed(
                lambda: make(n=48, order=order, dtype=F32))
            label = f"phase 8c: {label}(n=48, order={order})"
            log(f"{label}: {step.op.ndofs} DOFs, setup {setup_s:.2f} s")
            assert step.path == path, step.path
            res_b, s_b, l_b = check_step(step, u0, (D,),
                                         f"{label} best_bind", floor_ok=True)
            # the step again: the first pays one-time costs
            op = step.op
            step_s = {"lane": [s_b]}
            _, s, _ = check_step(step, u0, (D,), f"{label} lane",
                                 floor_ok=True)
            step_s["lane"].append(s)
            log(f"{label}: step s {step_s['lane']}")
            fz, Dz = op.bind_zchain(use_periodic=periodic)
            res_z, _, l_z = check_step(step, u0, (Dz,), f"{label} zchain",
                                       fn=fz, floor_ok=True)
            assert l_z["zchain"] > 0 and l_z["sumfact"] == 0, l_z
            assert (l_z["zchain_periodic"] > 0) == periodic, l_z
            d = rel2(res_z.x, res_b.x)
            log(f"{label}: z-chain vs best_bind solution 2-norm rel {d:.3e} "
                f"(tol 1e-4)")
            assert d <= 1e-4, d
            b4_launches += l_z["zchain"]
            del fz, Dz, res_z
            if not periodic:
                # the same kappa(z) step through the element-batched
                # operator in entity numbering, on the B1 kernel alone
                (pstep, (pu0, *parrays)), setup_s = timed(
                    lambda: vc_entry(n=48, order=order, operator="pa",
                                     dtype=F32))
                assert pstep.path == "cuda-btdb", pstep.path
                lat = pstep.lat
                assert torch.equal(pu0, u0[lat])
                pa_s = []
                for _ in range(2):  # the first pays one-time costs
                    res_pa, s, l_pa = check_step(
                        pstep, pu0, parrays, f"{label} pa", floor_ok=True)
                    pa_s.append(s)
                    assert l_pa["btdb"] > 0 and not any(
                        v for k, v in l_pa.items() if k != "btdb"), l_pa
                    b1_launches += l_pa["btdb"]
                d = rel2(torch.zeros_like(res_pa.x).index_copy_(
                    0, lat, res_pa.x), res_b.x)
                log(f"{label}: pa setup {setup_s:.2f} s; step s {pa_s}, "
                    f"arnoldi={res_pa.inner_iters}, {l_pa['btdb']} B1 "
                    f"launches per step (best_bind: {step_s['lane']} s, "
                    f"arnoldi={res_b.inner_iters}, "
                    f"{l_b['sumfact_fulld']} launches); pa vs best_bind "
                    f"solution 2-norm rel {d:.3e} (tol 1e-4)")
                assert d <= 1e-4, d
                pa_steps[order] = {
                    "step_s": min(pa_s), "arnoldi": res_pa.inner_iters,
                    "launches": l_pa["btdb"],
                    "best_bind_step_s": min(step_s["lane"]),
                    "best_bind_arnoldi": res_b.inner_iters}
                del pstep, pu0, parrays, lat, res_pa
            if periodic:
                b2_launches += l_b["sumfact"]
            else:
                b3_launches += l_b["sumfact_fulld"]
            del step, op, u0, D, res_b
            torch.cuda.empty_cache()

    # -- 9. slice 6: the application drivers ---------------------------------
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        drivers = run_drivers(dev, tmp, rel_l2_limit=JAX_9A_REL_L2)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # -- 10. slice 7: the nonlinear, vector, ALE and Q* drivers --------------
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nonlinear = [{**rec, "card": smi}
                     for rec in run_nonlinear_drivers(dev, tmp)]
    t10 = time.perf_counter() - t10
    log(f"phase 10: {t10:.1f} s (budget 45 s)")

    # -- 11. slice 8: the charring-ablator case 1 ----------------------------
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ablation = [{**rec, "card": smi}
                    for rec in run_ablation_case1(dev, tmp)]
    log(f"phase 11: {time.perf_counter() - t11:.1f} s (budget 45 s)")

    # -- 12. slice 9: the charring-ablator case 2.1 --------------------------
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ablation21 = [{**rec, "card": smi}
                      for rec in run_ablation_case21(dev, tmp)]
    log(f"phase 12: {time.perf_counter() - t12:.1f} s (budget 30 s)")

    # -- 13. slice 10: the charring-ablator case 2.2 -------------------------
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ablation22 = [{**rec, "card": smi}
                      for rec in run_ablation_case22(dev, tmp)]
    t13 = time.perf_counter() - t13
    log(f"phase 13: {t13:.1f} s (budget 40 s)")

    # -- 14. slice 11: line multigrid and the distributed operator layer ----
    t14 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        linemg = [{**rec, "card": smi} for rec in run_linemg(
            dev, tmp, pointblock_iters=ablation[2]["krylov_iters"])]
        t14a = time.perf_counter() - t14
        distributed = {**run_distributed(dev, tmp), "card": smi}
    t14b = time.perf_counter() - t14 - t14a
    gloo_on_card = run_gloo_on_card(dev)
    # only the line-MG kernels (14a) run here
    assert {k for k, v in counts().items() if v} <= {
        "line_factor", "line_solve"}, counts()
    t14 = time.perf_counter() - t14
    log(f"phase 14: {t14:.1f} s (budget 40 s): 14a {t14a:.1f} s, 14b "
        f"{t14b:.1f} s, 14c {t14 - t14a - t14b:.1f} s")

    # -- 15. slice 12: the distributed ablation Newton ------------------------
    # 15c's two gloo ranks start (imports, CUDA contexts) and run beside
    # 15a/15b, whose loops are host-bound on one core of the eight
    t15 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        gloo15 = pool.submit(run_ablation_gloo_on_card, dev, tmp)
        dist_ablation = run_distributed_ablation(
            dev, tmp, ablation[0]["first_step"],
            ablation22[0]["first_step"])
        t15ab = time.perf_counter() - t15
        dist_ablation["15c_gloo_on_card"] = gloo15.result()
    # no kernel lies on these paths
    assert not any(counts().values()), counts()
    dist_ablation["card"] = smi
    t15 = time.perf_counter() - t15
    log(f"phase 15: {t15:.1f} s (budget 40 s): 15a+15b {t15ab:.1f} s, 15c "
        f"{dist_ablation['15c_gloo_on_card']['spawn_s']:.1f} s beside them")

    # -- 16. slice 13: the study scripts ------------------------------------
    t16 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        scripts = {**run_scripts(dev, tmp), "card": smi}
    # only the line-MG kernels run here, in 16a's solves, and the study's
    # records count each of them
    lm16 = counts()
    assert {k for k, v in lm16.items() if v} == {
        "line_factor", "line_solve"}, lm16
    scripts["launches"] = {k: lm16[k] for k in ("line_factor", "line_solve")}
    solves16 = [r for st in scripts["refinement_refine0"]["states"].values()
                for r in (st["linemg"], st["pointblock"])]
    assert scripts["launches"] == {
        name: sum(r[f"launches_{key}"] for r in solves16)
        for name, key in (("line_factor", "factor"),
                          ("line_solve", "solve"))}, (lm16, solves16)
    t16 = time.perf_counter() - t16
    log(f"phase 16: {t16:.1f} s (budget 15 s)")

    def record(name, source, replaces, launches, err, k, p, bnd, **extra):
        return {"name": name, "route": "cuda",
                "source": f"cmfem_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": min(k), "plain_ms": min(p),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                # no one PyTorch call computes any of these functions: B1-B4
                # have a pointwise D stage between two contractions, and
                # torch has no block-tridiagonal elimination
                "library_ms": None, **extra}

    log("phase 8b: sweep median apply ms " + json.dumps(
        {f"p{o} {n}": v for (o, n), v in sweep.items()}))
    b4_2 = b4[2, False]
    lm = linemg[1]["kernels"]
    lm_err = {k: max(rec["kernels"]["max_abs_err"][k] for rec in linemg)
              for k in ("factor_and_solve", "solve")}
    log(json.dumps({"drivers": drivers}))
    log(json.dumps({"nonlinear_drivers": nonlinear}))
    log(json.dumps({"ablation_case1": ablation}))
    log(json.dumps({"ablation_case2_1": ablation21}))
    log(json.dumps({"ablation_case2_2": ablation22}))
    log(json.dumps({"linemg": linemg, "distributed": distributed,
                    "gloo_on_card": gloo_on_card}))
    log(json.dumps({"distributed_ablation": dist_ablation}))
    log(json.dumps({"scripts": scripts}))
    log(json.dumps({"kernels": [
        record("btdb", "btdb.cu", "cmfem_tpu/ops/partial.py:69",
               b1_launches, b1_abs, b1_k, b1_p, b1_bound, call_ms=b1_call,
               by_order=by_order["B1"], pa_steps=pa_steps,
               pa_apply_alone=pa_alone, by_shape=b1_new,
               shapes_checked=len(b1_shapes)),
        record("sumfact_fused", "sumfact_fused.cu",
               "cmfem_tpu/ops/sumfact.py:563", b2_launches, b2_abs, b2_k,
               b2_p, b2_bound, call_ms=b2_call, by_order=by_order["B2"]),
        record("sumfact_fused_fullD", "sumfact_fused.cu",
               "cmfem_tpu/ops/sumfact.py:365", b3_launches, b3_abs, b3_k,
               b3_p, b3_bound, call_ms=b3_call,
               max_abs_err_f64_mg_n48=mg_abs, by_order=by_order["B3"]),
        *[record(name, "linemg.cu",
                 f"cmfem_tpu/solvers/linemg.py:{line} (an XLA lax.scan; "
                 f"no Pallas kernel)",
                 sum(rec["linemg"]["launches"][name] for rec in linemg)
                 + scripts["launches"][name],
                 lm_err[key], [lm[name]["ms"]], [lm[name]["plain_ms"]],
                 lm[name]["bound"], levels=lm["levels"], NY=lm["NY"],
                 NX=lm["NX"], launches_16a=scripts["launches"][name],
                 call_ms=lm[name]["call_ms"],
                 by_level=[{"NX": lv["NX"], **lv[name]}
                           for lv in lm["by_level"]],
                 **({"chain": lm[name]["chain"]} if "chain" in lm[name]
                    else {}))
          for name, line, key in (("line_factor", 157, "factor_and_solve"),
                                  ("line_solve", 192, "solve"))],
        record("sumfact_zchain", "sumfact_zchain.cu",
               "cmfem_tpu/ops/sumfact.py:768", b4_launches,
               b4_2["max_abs_err"], [b4_2["ms"]], [b4_2["plain_ms"]],
               (b4_2["bound_ms"], b4_2["bound_by"]),
               call_ms=b4_2["call_ms"],
               by_order={f"p{o}_{'Dz' if per else 'fullD'}": v
                         for (o, per), v in b4.items()}),
    ]}))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
