"""Compensated-dot CG: does a Neumaier inner product buy float32 accuracy?

Port of the JAX package's ``scripts/compensated_dots.py``.  The SPD system
(mass + 0.1 diffusion, order 2, n^3 hexes of the unit cube, Dirichlet
walls, a seeded right-hand side (seed 7), applied through
``BilinearForm.apply``) is solved three ways:

  oracle : float64 CG on the CPU, rtol 1e-12
  plain  : float32 CG, the default dot (torch.dot)
  comp   : float32 CG, ``solvers.krylov.neumaier_dot``

both float32 solves at rtol 3e-7 on the card (unless --cpu), and each
float32 solution's rel-L2 deviation from the oracle, its CG iterations and
its solve seconds (the second of two solves) are reported.  If the float32
operator apply dominates the error, the two float32 columns agree and
compensated dots buy nothing.

    python -m cmfem_tpu_torch.scripts.compensated_dots [--n 24] [--cpu]
        [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import common

ORDER = 2


def build(n, dtype, device):
    """(ndofs, apply_A, b, Jacobi diagonal) of the n^3 system in ``dtype``
    on ``device`` (assembled in that dtype, as the JAX study's modes)."""
    from ..core import FESpace, make_cartesian_mesh_3d
    from ..ops import BilinearForm, EssentialBC, SpaceOps

    fes = FESpace(make_cartesian_mesh_3d(n, n, n), ORDER)
    ops = SpaceOps(fes, quad_order=2 * ORDER, device=device, dtype=dtype)
    form = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    data = form.assemble()
    bc = EssentialBC(fes.nscalar, fes.boundary_dofs(), device=device)
    diag = form.assemble_diagonal(data)
    b = np.random.default_rng(7).standard_normal(fes.nscalar)
    b[np.asarray(bc.ess_dofs.cpu())] = 0.0

    def apply_A(v):
        return torch.where(bc.mask, v, form.apply(data, v))

    Mdiag = torch.where(bc.mask, torch.ones_like(diag), diag)
    return (fes.nscalar, apply_A,
            torch.as_tensor(b, dtype=dtype, device=device), Mdiag)


def solve(system, rtol, dot=None):
    """Jacobi-preconditioned CG (maxiter 3000) on ``build``'s system."""
    from ..solvers import cg, jacobi_preconditioner

    _, apply_A, b, Mdiag = system
    return cg(apply_A, b, M=jacobi_preconditioner(Mdiag), rtol=rtol,
              maxiter=3000, dot=dot)


def run(n, device):
    """The oracle on the CPU, then both float32 solves on ``device``."""
    from ..solvers.krylov import neumaier_dot

    oracle = solve(build(n, torch.float64, torch.device("cpu")), 1e-12)
    if not oracle.converged:
        raise RuntimeError("the float64 oracle CG did not converge")
    x_ref = oracle.x.numpy()
    system = build(n, torch.float32, device)
    out = {"platform": torch.device(device).type,
           "card": common.card(device), "n": n, "ndofs": system[0],
           "oracle_iters": int(oracle.iters)}
    for name, dotfn in (("plain_vdot", None), ("neumaier", neumaier_dot)):
        solve(system, 3e-7, dotfn)                   # warm-up
        common.sync(device)
        t0 = time.perf_counter()
        res = solve(system, 3e-7, dotfn)
        common.sync(device)
        dt = time.perf_counter() - t0
        x = res.x.detach().cpu().numpy().astype(np.float64)
        out[name] = {"iters": int(res.iters),
                     "converged": bool(res.converged),
                     "rel_l2_vs_f64_oracle": float(
                         np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)),
                     "solve_s": round(dt, 4)}
    p = out["plain_vdot"]["rel_l2_vs_f64_oracle"]
    c = out["neumaier"]["rel_l2_vs_f64_oracle"]
    out["accuracy_gain_factor"] = round(p / max(c, 1e-300), 3)
    return out


def main(argv=None):
    ap = common.add_run_args(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("--n", type=int, default=24,
                    help="hexes per axis (default 24: 117,649 DOFs)")
    args = ap.parse_args(argv)
    out = run(args.n, common.run_device(args.cpu))
    print(json.dumps(out))
    out_dir = common.out_dir(args.out_dir, "compensated_dots")
    path = common.write_json(os.path.join(out_dir, "compensated_dots.json"),
                             out)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
