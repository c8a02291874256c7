"""Rank functions of the distributed parity tests (``test_torch_sharding``,
``test_torch_dofpart``, ``test_torch_sumfact_sharded``).

Each runs in a rank spawned by ``cmfem_tpu_torch.parallel.spawn_ranks``
(gloo on the CPU, one torch thread), builds its inputs from seeds with
numpy, runs several checks in one world and returns numpy results for the
test process to hold against the JAX package.  This module imports torch
and the port only: a rank never imports JAX.
"""

import numpy as np
import torch

from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_3d
from cmfem_tpu_torch.ops import BilinearForm, EssentialBC, SpaceOps

BETA = np.array([1.0, -2.0, 0.5])


def _np(t):
    return t.detach().cpu().numpy()


def sharding_problem(device):
    """The forms of ``tests/test_sharding.py`` on 3^3 hexes at order 2."""
    fes = FESpace(make_cartesian_mesh_3d(3, 3, 3), 2)
    ops = SpaceOps(fes, quad_order=4, device=device)
    cdr = (BilinearForm(ops).add_diffusion(0.3).add_mass(1.0)
           .add_convection(BETA))
    spd = BilinearForm(ops).add_diffusion(1.0).add_mass(0.5)
    return fes, ops, cdr, spd


def sharding_checks(n_devices, device="cpu"):
    """ShardedPoissonApply's apply of a seeded vector and the sharded
    Jacobi-CG of ``test_sharded_cg_solve_matches_single_device``."""
    from cmfem_tpu_torch.parallel import ShardedPoissonApply, make_device_mesh
    from cmfem_tpu_torch.solvers import cg, jacobi_preconditioner

    mesh = make_device_mesh(n_devices, device=device)
    fes, ops, cdr, spd = sharding_problem(mesh.device)
    data = cdr.assemble()
    A = ShardedPoissonApply(ops, data, mesh)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        fes.nscalar), device=mesh.device)
    y = A(u)
    sdata = spd.assemble()
    S = ShardedPoissonApply(ops, sdata, mesh)
    bc = EssentialBC(fes.nscalar, fes.boundary_dofs(), device=mesh.device)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(
        fes.nscalar), device=mesh.device)
    b = torch.where(bc.mask, 0.0, b)
    M = jacobi_preconditioner(torch.where(bc.mask, 1.0,
                                          spd.assemble_diagonal(sdata)))
    res = cg(bc.constrain_operator(S), b, M=M, rtol=1e-12, maxiter=500)
    refusals = []
    for want, kind in ((n_devices + 1, RuntimeError), (1, ValueError)):
        try:
            make_device_mesh(want, device=device)
        except kind as e:
            refusals.append(str(e))
    return {"rank": mesh.rank, "ne_pad": A.ne_pad, "y": _np(y),
            "x": _np(res.x), "iters": res.iters, "refusals": refusals}


def dofpart_problem(device, n=6):
    """The forms of ``tests/test_dofpart.py`` on n^3 hexes at order 2."""
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), 2)
    ops = SpaceOps(fes, quad_order=4, device=device)
    cdr = (BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
           .add_convection(BETA))
    spd = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    return fes, ops, cdr, spd


def dofpart_checks(n_devices, device="cpu", n=6):
    """On this rank: the three halo functions on seeded slabs, the CDR
    apply through ``DofPartitionedOperator`` and the Jacobi-CG of
    ``test_dofpart_cg_matches_replicated_solve`` (rtol 1e-13)."""
    from cmfem_tpu_torch.parallel import (DofPartitionedOperator,
                                          make_device_mesh)
    from cmfem_tpu_torch.parallel.dofpart import (halo_assemble,
                                                  halo_forward,
                                                  halo_reverse)
    from cmfem_tpu_torch.solvers import cg

    mesh = make_device_mesh(n_devices, device=device)
    dev = mesh.device
    fes, ops, cdr, spd = dofpart_problem(dev, n)
    op = DofPartitionedOperator(ops, cdr.assemble(), mesh)
    dp, r = op.part, mesh.rank
    rng = np.random.default_rng(3)
    u = rng.standard_normal(fes.nscalar)
    # halos: forward of u's slab, reverse and assemble of seeded local
    # vectors (the same (ndev, n_loc) array on every rank, one row each)
    t = lambda a: torch.as_tensor(a, device=dev)
    maps = (t(dp.pub_src_np[r]), t(dp.pub_dst_np[r]),
            t(dp.pub_src_rev_np[r]), t(dp.ghost_src_np[r]))
    nif = dp.n_interface
    fwd = halo_forward(op.to_dist(u), maps[0], maps[1], maps[3], nif,
                       dp.nghost_max, mesh)
    v_loc = np.random.default_rng(8).standard_normal((dp.ndev, dp.n_loc))
    rev = halo_reverse(t(v_loc[r]), maps[2], maps[1], maps[3], nif,
                       dp.nown_max, mesh)
    asm = halo_assemble(t(v_loc[r]), maps[0], maps[1], maps[2], maps[3],
                        nif, dp.nown_max, mesh)
    y = op.from_dist(op(op.to_dist(u)))
    roundtrip = op.from_dist(op.to_dist(u))
    # CG on the SPD form with the Jacobi preconditioner
    sdata = spd.assemble()
    sop = DofPartitionedOperator(ops, sdata, mesh)
    diag = spd.assemble_diagonal(sdata)
    b = np.random.default_rng(5).standard_normal(fes.nscalar)
    dinv = sop.to_dist(1.0 / diag)
    res = cg(sop, sop.to_dist(b), M=lambda v: dinv * v, rtol=1e-13,
             maxiter=2000, dot=sop.dot, norm=sop.norm)
    return {"rank": r, "fwd": _np(fwd), "rev": _np(rev), "asm": _np(asm),
            "y": _np(y), "roundtrip": _np(roundtrip), "x":
            _np(sop.from_dist(res.x)), "iters": res.iters,
            "converged": res.converged,
            "per_device_floats": op.per_device_floats()}


def sumfact_sharded_checks(n_devices, device="cpu", n=8):
    """ShardedSumFactOperator at orders 1 and 2 on n^3 hexes (the CDR form
    of ``tests/test_sumfact_sharded.py``, float64): the apply, the slabs
    after the halo sum, the layout round trip; then the CG of
    ``test_sharded_sumfact_cg_solve`` (order 1, the layout's plain dots)."""
    from cmfem_tpu_torch.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu_torch.parallel import make_device_mesh
    from cmfem_tpu_torch.solvers import cg

    mesh = make_device_mesh(n_devices, axis="z", device=device)
    dev, f64 = mesh.device, torch.float64
    out = {"rank": mesh.rank}
    for order in (1, 2):
        fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
        ops = SpaceOps(fes, quad_order=2 * order, device=dev)
        data = (BilinearForm(ops).add_diffusion(0.3).add_convection(BETA)
                .add_mass(1.0)).assemble()
        op = ShardedSumFactOperator(ops, data, n, n, n, order, mesh,
                                    dtype=f64)
        u = np.random.default_rng(0).standard_normal(op.ndofs)
        us = op.to_sharded(u)
        ys = op(us)
        out[order] = {"y": _np(op.from_sharded(ys)), "slab": _np(ys),
                      "roundtrip": _np(op.from_sharded(us)),
                      "weights": _np(op.ownership_weights())}
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), 1)
    ops = SpaceOps(fes, quad_order=2, device=dev)
    data = BilinearForm(ops).add_diffusion(1.0).add_mass(1.0).assemble()
    op = ShardedSumFactOperator(ops, data, n, n, n, 1, mesh, dtype=f64)
    b = np.random.default_rng(1).standard_normal(op.ndofs)
    res = cg(op, op.to_sharded(b), rtol=1e-12, maxiter=500, dot=op.dot,
             norm=op.norm)
    out["cg"] = {"x": _np(op.from_sharded(res.x)), "iters": res.iters}
    return out


# -- the distributed ablation Newton (test_torch_ablation_sharded/_dofpart) --

def _port_bc(bc):
    from cmfem_tpu_torch.physics.surface_bc import BoundaryState

    return None if bc is None else BoundaryState(*bc)


def _port_seb(seb):
    """(branch, model, table) of the port from (branch, model kwargs)."""
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.physics.seb import SurfaceFluxModel

    if seb is None:
        return None
    branch, kw = seb
    return (branch, SurfaceFluxModel(**kw), BPrimeTable.synthetic_tacot())


def ablation_system(device, inp):
    """The port's AblationSystem on the strip file ``inp["strip"]`` with the
    synthetic deck, gravity on, and the JAX package's geometric factors
    (``inp["gf"]``: detJ, invJ, wdetJ, xq), as
    ``torch_ablation_helpers.ablation_pair`` builds it."""
    from cmfem_tpu_torch.core import FESpace, GeometricFactors, load_gmsh
    from cmfem_tpu_torch.physics.ablation import AblationSystem
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    fes = FESpace(load_gmsh(inp["strip"]), 1)
    ops = SpaceOps(fes, quad_order=4, device=device)
    ops.gf = GeometricFactors(*(torch.as_tensor(a, device=device)
                                for a in inp["gf"]))
    return AblationSystem(ops, TacotMaterial.load_yaml(inp["deck"]),
                          gravity=(0.0, -9.81), top_attr=inp["top"])


def ablation_newton_checks(n_devices, kind, inp, device="cpu"):
    """On this rank, for each case of ``inp["cases"]`` (a dict of ess_T,
    ess_p, T, p, seb, bc, vertices, wq, gcl): ``kind``'s class
    ("sharded" or "dofpart") builds the residual, ``prepare``'s factors and
    the Newton direction; every distributed piece is gathered to the
    global layout of the JAX class (element slabs and owned slabs in rank
    order).  Returns per case the arrays, the GMRES counts and, for the
    DOF-partitioned class, ``per_device_floats``."""
    from cmfem_tpu_torch.parallel import (DofPartitionedAblationNewton,
                                          ShardedAblationNewton,
                                          make_device_mesh)

    mesh = make_device_mesh(n_devices, device=device)
    dev = mesh.device
    sys_ = ablation_system(dev, inp)
    t = lambda a: torch.as_tensor(a, device=dev)
    To_q, po_q, X = t(inp["To_q"]), t(inp["po_q"]), t(inp["extent"])
    out = {"rank": mesh.rank}
    for name, case in inp["cases"].items():
        kw = dict(restart=400, maxiter=10, seb=_port_seb(case["seb"]))
        T, p = t(case["T"]), t(case["p"])
        wq = None if case["wq"] is None else t(case["wq"])
        gcl = None if case["gcl"] is None else tuple(map(t, case["gcl"]))
        bc = _port_bc(case["bc"])
        if kind == "sharded":
            nw = ShardedAblationNewton(sys_, mesh, case["ess_T"],
                                       case["ess_p"], **kw)
            pack = lambda a, fill="dup": nw.pad_elem(a)
        else:
            nw = DofPartitionedAblationNewton(
                sys_, mesh, case["ess_T"], case["ess_p"],
                gcl_enabled=gcl is not None, **kw)
            pack = nw.pack_elem
        if case["vertices"] is not None:
            nw.update_geometry(t(case["vertices"]))
        slabs = (pack(To_q), pack(po_q), pack(X))
        ale = dict(bc=bc, wq=None if wq is None else pack(wq, "zero"),
                   gcl=None if gcl is None else (pack(gcl[0]),
                                                 pack(gcl[1])))
        if kind == "sharded":
            R = nw.residual(T, p, *slabs, inp["dt"], **ale)
            Je_s, pb, s = nw.prepare(T, p, *slabs, inp["dt"], **ale)
            res = nw.solve((Je_s, pb, s), -R, rtol=inp["rtol"])
            dx = res.x
        else:
            y = nw.to_dist2(T, p)
            Rd = nw.residual(y, *slabs, inp["dt"], **ale)
            R = torch.cat(nw.gather2(Rd))
            Je_s, pb, s = nw.prepare(y, *slabs, inp["dt"], **ale)
            res = nw.solve((Je_s, pb, s), -Rd, rtol=inp["rtol"])
            dx = torch.cat(nw.gather2(res.x))
            pb, s = mesh.all_gather(pb), mesh.all_gather(s)
            out.setdefault("per_device_floats", nw.per_device_floats())
            out.setdefault("roundtrip", [_np(a) for a in nw.gather2(y)])
        out[name] = {"R": _np(R), "Je_s": _np(mesh.all_gather(Je_s)),
                     "pb": _np(pb), "s": _np(s), "dx": _np(dx),
                     "iters": res.iters, "inner_iters": res.inner_iters,
                     "converged": res.converged}
    return out


# -- sharded checkpoints (test_torch_checkpoint) -------------------------------

def checkpoint_round_trip(n_devices, path, deck, device="cpu"):
    """On this rank: a ``DofPartitionedAblationNewton`` on a 3 x 20 strip
    and its state (the two-field slab of a seeded (T, p), the packed
    old-state slabs), saved with ``save_sharded`` and loaded back with
    ``load_sharded``.  Returns the saved and the loaded arrays (numpy) and
    the loaded step and time."""
    from cmfem_tpu_torch.core import make_strip_mesh_2d
    from cmfem_tpu_torch.io.checkpoint import load_sharded, save_sharded
    from cmfem_tpu_torch.parallel import (DofPartitionedAblationNewton,
                                          make_device_mesh)
    from cmfem_tpu_torch.physics.ablation import (AblationState,
                                                  AblationSystem)
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    mesh = make_device_mesh(n_devices, device=device)
    dev = mesh.device
    fes = FESpace(make_strip_mesh_2d(3, 20), 1)
    ops = SpaceOps(fes, quad_order=4, device=dev)
    sys_ = AblationSystem(ops, TacotMaterial.load_yaml(deck), top_attr=3)
    top = fes.boundary_dofs([3])
    dn = DofPartitionedAblationNewton(sys_, mesh, top, top)
    rng = np.random.default_rng(4)
    T = torch.as_tensor(300.0 + 900.0 * rng.random(fes.nscalar), device=dev)
    p = torch.as_tensor(1e5 * (1.0 + rng.random(fes.nscalar)), device=dev)
    X = AblationState.initial(sys_.ne, sys_.nq, sys_.mat, device=dev).extent
    saved = {"y": dn.to_dist2(T, p),
             "To": dn.pack_elem(ops.values_at_qp(T), "dup"),
             "po": dn.pack_elem(ops.values_at_qp(p), "dup"),
             "Xo": dn.pack_elem(X + 0.25, "dup")}
    save_sharded(path, 7, 0.7, saved)
    step, time, loaded = load_sharded(path, device=dev)
    return {"rank": mesh.rank, "step": step, "time": time,
            "saved": {k: _np(v) for k, v in saved.items()},
            "loaded": {k: _np(v) for k, v in loaded.items()},
            "devices": {k: str(v.device) for k, v in loaded.items()}}


# -- GMRES with reductions over the ranks (test_torch_krylov_reduce) ----------

def gmres_slab_checks(n_devices, A, b, restart, device="cpu"):
    """Restarted GMRES on this rank's slab of A x = b (rows split in rank
    order, the matvec gathers the slabs) with ``reduce=mesh.all_reduce``,
    the reduce calls counted.  Returns the gathered x, the counts and the
    number of reduce calls."""
    from cmfem_tpu_torch.parallel import make_device_mesh
    from cmfem_tpu_torch.solvers import gmres

    mesh = make_device_mesh(n_devices, device=device)
    n = len(b)
    per = -(-n // n_devices)
    lo, hi = mesh.rank * per, min(n, (mesh.rank + 1) * per)
    At = torch.as_tensor(A, device=mesh.device)
    calls = [0]

    def matvec(x):
        full = mesh.all_gather(torch.nn.functional.pad(
            x, (0, per - len(x)))).reshape(-1)[:n]
        return (At @ full)[lo:hi]

    def reduce(t):
        calls[0] += 1
        return mesh.all_reduce(t)

    diag = torch.as_tensor(np.diag(A)[lo:hi].copy(), device=mesh.device)
    res = gmres(matvec, torch.as_tensor(b[lo:hi], device=mesh.device),
                M=lambda r: r / diag, rtol=1e-10, restart=restart,
                maxiter=20, reduce=reduce)
    x = mesh.all_gather(torch.nn.functional.pad(
        res.x, (0, per - len(res.x)))).reshape(-1)[:n]
    return {"x": _np(x), "iters": res.iters, "inner_iters": res.inner_iters,
            "converged": res.converged, "calls": calls[0]}
