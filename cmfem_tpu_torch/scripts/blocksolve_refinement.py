"""Refinement study of the ablation Newton systems' iterative solvers.

Port of the JAX package's ``scripts/blocksolve_refinement.py``.  The
reference solves every ablation Newton system with a direct LU; the
iterative replacement is GMRES on the equilibrated (T, p) block system,
preconditioned by the 2x2 point blocks (``pc="pointblock"``, the contrast:
its counts grow ~2.7x per refinement) or by the line multigrid
(``pc="linemg"``: x-semicoarsened multigrid with exact y-line smoothing,
``solvers.linemg.StripLineMG``, whose line solves are the CUDA kernels of
``csrc/linemg.cu`` on the card).  This study measures both on the case-2.2
system (SEB top flux, ``SurfaceFluxModel(case22=True)``) under uniform
refinement of the strip, for two synthetic states (``make_states``):

  heating       : cold interior, hot wall boundary layer, chemistry-blowing
                  surface branch
  char_cooldown : charred top, hot subsurface, cooled wall
                  (cooling_standard branch) and >= 1 mm of graded
                  recession applied to the mesh

line MG at every refinement, the point blocks at refine <=
``pointblock_max_refine``.  Refine 0 / 1 / 2 / 3 are 12 x 240 / 23 x 479 /
45 x 957 / 89 x 1913 nodes: 5,760 / 22,034 / 86,130 / 340,514 (T, p) DOFs.

Inputs, in place of the reference's: the synthetic TACOT deck
``tests/fixtures/tacot_synthetic.json`` for material_tacot_case2_2.yaml,
``BPrimeTable.synthetic_tacot()`` for the B' table, and the graded strip
``core.make_strip_mesh_2d(11, 239)`` (written and read back as GMSH) for
ablation_strip.msh, whose top boundary is attribute 3 here
(``common.STRIP_TOP``) where the reference mesh's is 1.

Each record holds JAX's keys (cycles, inner_iters, converged,
prepare_plus_solve_s, rel_residual: the preconditioned residual over
|R|, known problem 3) and the port's: the line-MG level widths
(``nxs``), the line kernels' launches in the timed run, and per level the
peak device memory and, on the card, the finest level's ``line_factor``
and ``line_solve`` device ms per call beside their bounds.  A partial
JSON is flushed after every level.

    python -m cmfem_tpu_torch.scripts.blocksolve_refinement [0 1 2 3]
        [--cpu] [--out-dir DIR] [--nx 11 --ny 239]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import common


def make_states(fes, sys_, mat, n, verts0):
    """Two (name, T, p, X, verts, chemistryOn) synthetic states spanning the
    run, numpy arrays (the JAX study's arithmetic, on the quadrature points
    of ``sys_.ops``)."""
    pos = np.asarray(fes.node_positions)
    ytop = pos[:, 1].max()
    depth = ytop - pos[:, 1]

    # per-QP depth for the extent fields
    xq = sys_.ops.gf.xq.detach().cpu().numpy()  # (ne, nq, dim)
    dq = ytop - xq[..., 1]
    nr = mat.num_reactions

    # heating: cold interior, hot thermal boundary layer (~2 mm)
    T_heat = 300.0 + 1300.0 * np.exp(-depth / 2e-3)
    X_heat = np.clip(np.exp(-dq / 1e-3), 0.0, 1.0)[..., None] \
        * np.ones(nr)
    X_heat = 0.3 * X_heat  # partially reacted

    # char + cooldown: fully charred top, subsurface peak, cooled wall
    T_cool = (300.0 + 400.0 * np.exp(-depth / 2e-3)
              + 700.0 * np.exp(-((depth - 4e-3) / 3e-3) ** 2))
    X_cool = np.clip(1.0 - dq / 1.5e-3, 0.0, 1.0)
    X_cool = np.maximum(X_cool[..., None] * np.ones(nr),
                        np.clip(np.exp(-dq / 3e-3), 0.0, 1.0)[..., None]
                        * 0.99)

    # recession >= 1 mm: graded pull-down, strongest at the top
    verts_rec = np.asarray(verts0).copy()
    vdepth = ytop - verts_rec[:, 1]
    verts_rec[:, 1] -= 1.2e-3 * np.exp(-vdepth / (0.4 * ytop))

    p0 = np.full(n, 101325.0)
    return [
        ("heating", T_heat, p0, X_heat, np.asarray(verts0), 1),
        ("char_cooldown", T_cool, p0, X_cool, verts_rec, 0),
    ]


def level(mesh, device):
    """(fes, sys_, ess, lattice) of one refinement: order-1 space, quadrature
    order 4, float64, p Dirichlet on the top boundary."""
    from ..core import FESpace
    from ..ops import SpaceOps
    from ..physics.ablation import AblationSystem
    from ..physics.tacot import TacotMaterial
    from ..solvers.blocksolve import strip_dof_lattice

    fes = FESpace(mesh, 1)
    ops = SpaceOps(fes, quad_order=4, device=device)
    sys_ = AblationSystem(ops, TacotMaterial.load_yaml(common.TACOT_DECK),
                          top_attr=common.STRIP_TOP)
    ess = np.asarray(fes.boundary_dofs([common.STRIP_TOP]))
    try:
        lat = strip_dof_lattice(fes.node_positions)
    except ValueError:
        lat = None
    return fes, sys_, ess, lat


def state_system(sys_, ess, state, dt, model, bprime):
    """The first Newton system of one state: (branch, R, element blocks,
    face blocks), with R the residual (SEB face term included) zeroed on
    the p Dirichlet rows."""
    from ..physics.seb import classify_branch
    from ..physics.surface_bc import BoundaryState

    _, T_np, p_np, X_np, verts, chem = state
    ops, n = sys_.ops, sys_.n
    dev = ops.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                  dtype=torch.float64, device=dev)
    T, p = t(T_np), t(p_np)
    X = t(np.broadcast_to(X_np.reshape(sys_.ne, sys_.nq, -1),
                          (sys_.ne, sys_.nq, sys_.mat.num_reactions)))
    v = t(verts)
    gf = ops.geometric_factors(v)
    bc = BoundaryState(p_w=101325.0, rhoeUeCH=0.3 if chem else 0.003,
                       h_r=1.5e6 if chem else 0.0, hconv=0.0, Tedge=300.0,
                       has_hconv=False, has_Tedge=False, chemistryOn=chem)
    branch = classify_branch(bc, model)
    To, po = ops.values_at_qp(T), ops.values_at_qp(p)
    mask2 = torch.zeros(2 * n, dtype=torch.bool, device=dev)
    mask2[torch.as_tensor(ess + n, device=dev)] = True
    RT, Rp = sys_.residual(T, p, To, po, X, dt, gf=gf)
    RT = RT + sys_.seb_face_residual(T, p, X, bc, branch, model, bprime,
                                     vertices=v)
    R = torch.where(mask2, 0.0, torch.cat([RT, Rp]))
    blocks = sys_.element_jacobians(T, p, To, po, X, dt, gf=gf)
    face = sys_.seb_face_jacobians(T, p, X, bc, branch, model, bprime,
                                   vertices=v)
    return branch, R, blocks, face


def solvers_of(fes, ess, lat, lvl, restart, maxiter, pointblock_max_refine,
               device):
    """{"linemg": ..., "pointblock": ...} (the point blocks at refine <=
    ``pointblock_max_refine`` only), as the JAX study builds them."""
    from ..solvers.blocksolve import BlockNewtonKrylov

    args = (np.asarray(fes.element_dofs), fes.nscalar,
            np.zeros(0, dtype=np.int64), ess)
    out = {"linemg": BlockNewtonKrylov(*args, restart=60, maxiter=5,
                                       dof_lattice=lat, pc="linemg",
                                       device=device)}
    if lvl <= pointblock_max_refine:
        out["pointblock"] = BlockNewtonKrylov(
            *args, restart=restart, maxiter=maxiter, dof_lattice=lat,
            device=device)
    return out


def line_kernel_ms(arrs, device):
    """The finest level's ``line_factor`` and ``line_solve``: device ms per
    call, ms of one call between CUDA events and bound ms
    (``kernels.linemg.level_times``).  These launches are not the study's:
    its counts are read before."""
    from ..kernels import linemg as klmg

    SS, fac = arrs[0]
    NY, NX = SS.shape[2], SS.shape[3]
    gen = torch.Generator(device=device).manual_seed(0)
    r = torch.randn(NY, NX, 2, dtype=SS.dtype, device=device, generator=gen)
    return {f"{name}_{key}": v
            for name, t in klmg.level_times(SS, fac, r).items()
            for key, v in (("ms", t["ms"]), ("call_ms", t["call_ms"]),
                           ("bound_ms", t["bound_ms"]),
                           ("bound_by", t["bound_by"]))}


def run_study(refinements=(0, 1, 2, 3), rtol=1e-6, dt=0.0025, restart=400,
              maxiter=10, pointblock_max_refine=1, *, device, out_dir,
              nx=11, ny=239, timed=True):
    """Both preconditioners under strip refinement (the JAX study's
    ``run_study``): ``linemg`` at every refinement, ``pointblock`` with the
    restart x maxiter budget at refinements <= ``pointblock_max_refine``.
    With ``timed`` each solve (prepare + solve) runs twice, the first to
    warm up (kernel build, allocator), the second timed and counted, and
    on the card the finest level's line kernels are timed after it.
    Without, each solve runs once and the study launches nothing else: its
    records' launches are then all the line kernels' launches of the call
    (chip_smoke phase 16, whose kernels are built and timed before)."""
    from ..core import load_gmsh
    from ..kernels import linemg as klmg
    from ..physics.bprime import BPrimeTable
    from ..physics.seb import SurfaceFluxModel

    device = torch.device(device)
    cuda = device.type == "cuda"
    model = SurfaceFluxModel(case22=True)
    bprime = BPrimeTable.synthetic_tacot()
    base_mesh = load_gmsh(common.strip_file(out_dir, nx, ny))

    out = {"rtol": rtol, "dt": dt, "restart": restart,
           "platform": device.type, "card": common.card(device),
           "strip_cells": [nx, ny], "levels": []}
    for lvl in refinements:
        common.reset_peak(device)
        mesh = base_mesh.uniform_refine(lvl) if lvl else base_mesh
        fes, sys_, ess, lat = level(mesh, device)
        n = fes.nscalar
        solvers = solvers_of(fes, ess, lat, lvl, restart, maxiter,
                             pointblock_max_refine, device)
        face_elem = sys_.trace.elem
        NY, NX = np.asarray(lat).shape
        rec = {"refine": lvl, "ndofs_tp": 2 * n, "NY": int(NY),
               "NX": int(NX), "nxs": solvers["linemg"].mg.nxs, "states": {}}
        for state in make_states(fes, sys_, sys_.mat, n, mesh.vertices):
            name = state[0]
            branch, R, blocks, face = state_system(sys_, ess, state, dt,
                                                   model, bprime)
            rnorm = max(1e-300, float(torch.linalg.vector_norm(R)))
            st = {"branch": branch}
            for pc_name, bks in solvers.items():
                if timed:                                 # warm-up
                    fac = bks.prepare(blocks, face=face, face_elem=face_elem)
                    res = bks.solve(fac, -R, rtol=rtol)
                    common.sync(device)
                before = (klmg.launches_factor, klmg.launches_solve)
                t0 = time.perf_counter()
                fac = bks.prepare(blocks, face=face, face_elem=face_elem)
                res = bks.solve(fac, -R, rtol=rtol)
                common.sync(device)
                wall = time.perf_counter() - t0
                st[pc_name] = {
                    "cycles": int(res.iters),
                    "inner_iters": int(res.inner_iters),
                    "converged": bool(res.converged),
                    "prepare_plus_solve_s": round(wall, 4),
                    "rel_residual": float(res.residual / rnorm),
                    "launches_factor": klmg.launches_factor - before[0],
                    "launches_solve": klmg.launches_solve - before[1],
                }
                if timed and cuda and pc_name == "linemg" \
                        and "line_solve_ms" not in rec:
                    rec.update(line_kernel_ms(fac[1], device))
                print(f"# refine={lvl} ndofs_tp={2 * n} state={name} "
                      f"pc={pc_name} cycles={int(res.iters)} "
                      f"inner={int(res.inner_iters)} "
                      f"converged={bool(res.converged)} "
                      f"wall={wall:.3f}s", file=sys.stderr, flush=True)
                del fac, res
            rec["states"][name] = st
            del R, blocks, face
        rec["peak_gib"] = common.peak_gib(device)
        out["levels"].append(rec)
        del solvers, sys_, fes
        if cuda:
            torch.cuda.empty_cache()
        # flush after every level: a run cut at its time limit keeps the
        # completed levels
        common.write_json(os.path.join(
            out_dir, "blocksolve_refinement.partial.json"), out)

    # growth factor per level for the h-robust path
    growth = {}
    for name in out["levels"][0]["states"]:
        iters = [lv["states"][name]["linemg"]["inner_iters"]
                 for lv in out["levels"]]
        growth[name] = {
            "linemg_inner_iters_by_level": iters,
            "linemg_growth_per_level": [
                round(b / max(1, a), 2) for a, b in zip(iters, iters[1:])],
        }
    out["linemg_growth"] = growth
    return out


def main(argv=None):
    ap = common.add_run_args(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("refinements", nargs="*", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--nx", type=int, default=11)
    ap.add_argument("--ny", type=int, default=239)
    args = ap.parse_args(argv)
    device = common.run_device(args.cpu)
    out_dir = common.out_dir(args.out_dir, "blocksolve_refinement")
    study = run_study(tuple(args.refinements), device=device,
                      out_dir=out_dir, nx=args.nx, ny=args.ny)
    path = common.write_json(
        os.path.join(out_dir, "blocksolve_refinement.json"), study)
    print(f"wrote {path}")
    return 0 if all(lv["states"][s]["linemg"]["converged"]
                    for lv in study["levels"] for s in lv["states"]) else 1


if __name__ == "__main__":
    sys.exit(main())
