"""The slice's main path: one implicit backward-Euler step of 3D
convection-diffusion-reaction on a structured hex lattice.

Port of ``__graft_entry__.entry()``: the mesh is ``make_cartesian_mesh_3d``,
the form ``mass + dt*convection(beta=[1,-2,0.5]) + 0.1*dt*diffusion`` is
assembled (in float64) into quadrature-point data, the operator is applied
matrix-free by ``SumFactoredOperator`` bound through ``best_bind`` (the CUDA
kernel on a GPU), and the step is a Jacobi-preconditioned Krylov solve with
homogeneous Dirichlet walls.

The convection term makes the operator nonsymmetric, and Jacobi-CG
stagnates on it, so the step solves with GMRES(30) by default;
``solver="cg"`` reproduces the JAX package's step (CG, maxiter 100).
``spd_step`` solves the SPD form mass + 0.1*dt*diffusion with CG.
"""

from __future__ import annotations

import numpy as np
import torch

from . import require_cuda
from .core import FESpace, make_cartesian_mesh_3d
from .interop import lattice_diagonal
from .ops import BilinearForm, SpaceOps
from .ops.partial import StructuredGrid3D
from .ops.sumfact import SumFactoredOperator
from .solvers import SolveResult, cg, gmres, jacobi_preconditioner

DT = 1.0e-2
BETA = np.array([1.0, -2.0, 0.5])


class BEStep:
    """One BE step ``step(u, D) -> SolveResult`` on a bound operator.

    ``op`` is the SumFactoredOperator, ``path`` the name of the apply path
    ``best_bind`` chose, ``fn`` its apply.  ``solve(u, fn, D)`` runs the
    same step through another apply (e.g. the plain chain)."""

    def __init__(self, op, fn, path, mask, M, solver):
        if solver not in ("gmres", "cg"):
            raise ValueError(f"solver must be 'gmres' or 'cg', got {solver!r}")
        self.op, self.fn, self.path = op, fn, path
        self.mask, self.M, self.solver = mask, M, solver

    def apply_A(self, fn, D):
        """The Dirichlet-constrained operator: identity on wall rows."""
        mask = self.mask
        return lambda v: torch.where(mask, v,
                                     fn(torch.where(mask, 0.0, v), D))

    def solve(self, u, fn, D) -> SolveResult:
        B = torch.where(self.mask, 0.0, u)
        A = self.apply_A(fn, D)
        if self.solver == "gmres":
            return gmres(A, B, x0=u, M=self.M, rtol=1e-6, restart=30)
        return cg(A, B, x0=u, M=self.M, rtol=1e-6, maxiter=100)

    def __call__(self, u, D) -> SolveResult:
        return self.solve(u, self.fn, D)


def _step(form_fn, n, order, device, dtype, solver):
    device = require_cuda() if device is None else torch.device(device)
    mesh = make_cartesian_mesh_3d(n, n, n)
    fes = FESpace(mesh, order)
    ops = SpaceOps(fes, quad_order=2 * order, device=device,
                   dtype=torch.float64)
    lhs = form_fn(BilinearForm(ops))
    ldata = lhs.assemble()
    op = SumFactoredOperator(ops, ldata, n, n, n, order, device=device,
                             dtype=dtype)
    fn, D, path = op.best_bind()
    grid = StructuredGrid3D(n, n, n, order)
    mask = torch.as_tensor(grid.boundary_mask(), device=device)
    # lattice-numbered Jacobi diagonal via position matching
    diag = lattice_diagonal(lhs.assemble_diagonal(ldata), fes.node_positions,
                            grid, device=device, dtype=dtype)
    M = jacobi_preconditioner(torch.where(mask, 1.0, diag))
    u0 = torch.zeros(grid.ndofs, dtype=dtype, device=device)
    u0[grid.ndofs // 2] = 1.0
    return BEStep(op, fn, path, mask, M, solver), (u0, D)


def entry(n: int = 48, order: int = 2, device=None, dtype=torch.float32,
          solver: str = "gmres"):
    """(step, (u0, D)): the CDR BE step at n^3 elements of order ``order``.

    ``device=None`` means the CUDA device (RuntimeError without one)."""
    return _step(lambda f: (f.add_mass(1.0)
                            .add_convection(BETA, alpha=DT)
                            .add_diffusion(0.1 * DT)),
                 n, order, device, dtype, solver)


def spd_step(n: int = 48, order: int = 2, device=None, dtype=torch.float32):
    """(step, (u0, D)): the SPD mass + 0.1*dt*diffusion step, solved by CG."""
    return _step(lambda f: f.add_mass(1.0).add_diffusion(0.1 * DT),
                 n, order, device, dtype, "cg")
