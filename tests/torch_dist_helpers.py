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
