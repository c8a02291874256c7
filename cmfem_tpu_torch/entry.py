"""The port's entry points on a structured hex lattice of the unit cube.

Slice 1, ``entry``: one implicit backward-Euler step of 3D
convection-diffusion-reaction, a port of ``__graft_entry__.entry()``.  The
mesh is ``make_cartesian_mesh_3d``, the form
``mass + dt*convection(beta=[1,-2,0.5]) + 0.1*dt*diffusion`` is assembled
(in float64) into quadrature-point data, the operator is applied
matrix-free by ``SumFactoredOperator`` bound through ``best_bind`` (the CUDA
kernel on a GPU), and the step is a Jacobi-preconditioned Krylov solve with
homogeneous Dirichlet walls.  The convection term makes the operator
nonsymmetric, and Jacobi-CG stagnates on it, so the step solves with
GMRES(30) by default; ``solver="cg"`` reproduces the JAX package's step (CG,
maxiter 100).  ``spd_step`` solves the SPD form mass + 0.1*dt*diffusion
with CG.

Slice 2:

- ``vc_entry``: the same step with the variable conductivity
  ``dt*diffusion(KAPPA)``, kappa = 0.1 + z^2, in place of
  ``0.1*dt*diffusion``.  The operator is then not z-periodic, and it is
  applied by one of three operators: ``"sumfact"`` (``best_bind``: the
  full-D sum-factorization kernel on a GPU), ``"structured-pa"`` (lattice
  gather/scatter + the element-batched B^T D B kernel) or ``"pa"``
  (entity numbering, ``u[eldofs]`` gather and ``index_add_`` scatter + the
  same kernel);
- ``mg_solve``: -div(kappa grad u) = f on the unit cube with homogeneous
  Dirichlet walls and the manufactured solution
  u = sin(pi x) sin(pi y) sin(pi z), by CG preconditioned with
  ``StructuredMG`` (or Jacobi), as ``bench.py::bench_mg`` runs it.

Slice 3, ``operator_paths``: the operator-apply paths that
``bench.py::bench_operator`` sweeps at orders 2-4, on one form, each an
apply of the same lattice-numbered vector (the timing lives in
``chip_smoke.py``).  ``entry`` and ``vc_entry`` run at orders 3 and 4
unchanged; their steps go through the z-chain with
``step.solve(u0, *op.bind_zchain(...))``.

The distributed operator layer, ``dryrun_multichip(n_devices)``: the
counterpart of ``__graft_entry__.dryrun_multichip`` without its ablation
sections (they come with the distributed ablation Newton): an implicit CDR
step through ``ShardedPoissonApply`` and CG, a Jacobi-CG solve on
``DofPartitionedOperator`` against the single-device PA solve, and the
z-split sum-factorized apply against ``SumFactoredOperator``.  On the CPU
it spawns ``n_devices`` gloo ranks; on the card one NCCL rank per card.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from . import require_cuda
from .core import FESpace, make_cartesian_mesh_3d
from .interop import lattice_diagonal, lattice_index
from .ops import BilinearForm, EssentialBC, SpaceOps, domain_lf, l2_error
from .ops.partial import PAOperator, StructuredGrid3D, StructuredPAOperator
from .ops.sumfact import SumFactoredOperator
from .solvers import SolveResult, cg, gmres, jacobi_preconditioner
from .solvers.multigrid import StructuredMG

DT = 1.0e-2
BETA = np.array([1.0, -2.0, 0.5])


def KAPPA(x):
    """The variable conductivity kappa(x) = 0.1 + z^2 (x: (..., 3))."""
    return 0.1 + x[:, 2] ** 2


OPERATORS = ("sumfact", "structured-pa", "pa")
# operator_paths' names; the *-periodic paths exist only for z-periodic D
PATHS = ("sumfact", "sumfact-periodic", "sumfact-fused",
         "sumfact-zfma-periodic", "sumfact-zchain", "sumfact-zchain-periodic",
         "structured-pa", "pa")


class BEStep:
    """One BE step ``step(u, *arrays) -> SolveResult`` on a bound operator.

    ``op`` is the operator, ``path`` the name of the apply path it was
    bound to, ``fn(v, *arrays)`` its apply.  ``solve(u, fn, *arrays)`` runs
    the same step through another apply (e.g. the plain chain).  ``lat``
    (entity-numbered steps only) maps entity to lattice numbering:
    ``x_lattice[lat] = x``."""

    def __init__(self, op, fn, path, mask, M, solver, lat=None):
        if solver not in ("gmres", "cg"):
            raise ValueError(f"solver must be 'gmres' or 'cg', got {solver!r}")
        self.op, self.fn, self.path = op, fn, path
        self.mask, self.M, self.solver = mask, M, solver
        self.lat = lat

    def apply_A(self, fn, *arrays):
        """The Dirichlet-constrained operator: identity on wall rows."""
        mask = self.mask
        return lambda v: torch.where(mask, v,
                                     fn(torch.where(mask, 0.0, v), *arrays))

    def solve(self, u, fn, *arrays) -> SolveResult:
        B = torch.where(self.mask, 0.0, u)
        A = self.apply_A(fn, *arrays)
        if self.solver == "gmres":
            return gmres(A, B, x0=u, M=self.M, rtol=1e-6, restart=30)
        return cg(A, B, x0=u, M=self.M, rtol=1e-6, maxiter=100)

    def __call__(self, u, *arrays) -> SolveResult:
        return self.solve(u, self.fn, *arrays)


def _device(device):
    return require_cuda() if device is None else torch.device(device)


def _step(form_fn, n, order, device, dtype, solver, operator="sumfact"):
    if operator not in OPERATORS:
        raise ValueError(f"operator must be one of {OPERATORS}, "
                         f"got {operator!r}")
    device = _device(device)
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
    ops = SpaceOps(fes, quad_order=2 * order, device=device,
                   dtype=torch.float64)
    lhs = form_fn(BilinearForm(ops))
    ldata = lhs.assemble()
    diag = lhs.assemble_diagonal(ldata)
    grid = StructuredGrid3D(n, n, n, order)
    # the unit spike of u0 sits at the middle lattice DOF in every numbering
    spike = grid.ndofs // 2
    lat = None
    if operator == "pa":
        op = PAOperator(ops, ldata, dtype=dtype)
        fn, *arrays = op.bind()
        path = op.path
        mask = EssentialBC(fes.nscalar, fes.boundary_dofs(),
                           device=device).mask
        diag = diag.to(dtype)
        lat = torch.as_tensor(lattice_index(fes, grid), device=device)
        spike = int(torch.nonzero(lat == spike)[0, 0])
    else:
        if operator == "sumfact":
            op = SumFactoredOperator(ops, ldata, n, n, n, order,
                                     device=device, dtype=dtype)
            fn, D, path = op.best_bind()
        else:
            op = StructuredPAOperator(ops, ldata, grid, dtype=dtype)
            fn, D = op.bind()
            path = op.path
        arrays = [D]
        mask = torch.as_tensor(grid.boundary_mask(), device=device)
        diag = lattice_diagonal(diag, fes, grid, device=device, dtype=dtype)
    M = jacobi_preconditioner(torch.where(mask, 1.0, diag))
    u0 = torch.zeros(grid.ndofs, dtype=dtype, device=device)
    u0[spike] = 1.0
    return BEStep(op, fn, path, mask, M, solver, lat), (u0, *arrays)


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


def vc_entry(n: int = 48, order: int = 2, operator: str = "sumfact",
             device=None, dtype=torch.float32, solver: str = "gmres"):
    """(step, (u0, *arrays)): the CDR BE step with kappa = 0.1 + z^2.

    ``operator`` is ``"sumfact"`` (lattice numbering, ``best_bind``),
    ``"structured-pa"`` (lattice numbering, arrays (Dflat,)) or ``"pa"``
    (entity numbering, arrays (Dflat, eldofs_T); ``step.lat`` maps to the
    lattice).  ``device=None`` means the CUDA device."""
    return _step(lambda f: (f.add_mass(1.0)
                            .add_convection(BETA, alpha=DT)
                            .add_diffusion(lambda x: DT * KAPPA(x))),
                 n, order, device, dtype, solver, operator)


def mms_exact(x):
    """The manufactured solution u = sin(pi x) sin(pi y) sin(pi z)."""
    s = torch.sin(math.pi * x)
    return s[:, 0] * s[:, 1] * s[:, 2]


def mms_source(x):
    """f = -div(kappa grad u) = kappa 3 pi^2 u - 2 z pi sin(pi x) sin(pi y)
    cos(pi z) for u = mms_exact, kappa = KAPPA."""
    s = torch.sin(math.pi * x)
    cz = torch.cos(math.pi * x[:, 2])
    return (KAPPA(x) * 3 * math.pi ** 2 * mms_exact(x)
            - 2 * x[:, 2] * math.pi * s[:, 0] * s[:, 1] * cz)


class MGSolve(NamedTuple):
    result: SolveResult  # in lattice numbering
    l2_error: float      # ||u_h - u||_L2 (elevated quadrature)
    path: str            # the fine-level operator's apply path
    op: SumFactoredOperator  # the fine-level operator
    setup_s: float       # host clock, device synchronized
    solve_s: float


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mg_solve(n: int = 48, order: int = 2, device=None, dtype=torch.float64,
             rtol: float = 1e-8, precond: str = "mg") -> MGSolve:
    """Solve -div(kappa grad u) = f, u = 0 on the walls, by PCG.

    The operator is ``diffusion(KAPPA)`` through ``best_bind``; the
    right-hand side is ``domain_lf(mms_source)`` moved to the lattice.
    ``precond="mg"``: a StructuredMG V-cycle, maxiter 200; ``"jacobi"``:
    Jacobi, maxiter 2000 (as ``bench.py::bench_mg``)."""
    if precond not in ("mg", "jacobi"):
        raise ValueError(f"precond must be 'mg' or 'jacobi', got {precond!r}")
    device = _device(device)
    _sync(device)
    t0 = time.perf_counter()
    make_form = lambda ops: BilinearForm(ops).add_diffusion(KAPPA)
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
    ops = SpaceOps(fes, quad_order=max(2, 2 * order), device=device,
                   dtype=torch.float64)
    grid = StructuredGrid3D(n, n, n, order)
    lat = torch.as_tensor(lattice_index(fes, grid), device=device)
    mask = torch.as_tensor(grid.boundary_mask(), device=device)
    b = torch.zeros(grid.ndofs, dtype=dtype, device=device)
    b[lat] = domain_lf(ops, mms_source).to(dtype)
    b = torch.where(mask, 0.0, b)
    if precond == "mg":
        mg = StructuredMG.build(n, order, make_form, device=device,
                                dtype=dtype)
        op = mg.levels[0]["op"]
        Mmg, arrs = mg.bind()
        M, maxiter = (lambda r: Mmg(r, arrs)), 200
    else:
        form = make_form(ops)
        data = form.assemble()
        op = SumFactoredOperator(ops, data, n, n, n, order, device=device,
                                 dtype=dtype)
        diag = torch.where(mask, 1.0, lattice_diagonal(
            form.assemble_diagonal(data), fes, grid, device=device,
            dtype=dtype))
        del form, data
        M, maxiter = jacobi_preconditioner(diag), 2000
    fn, D, path = op.best_bind()

    def apply_A(v):
        return torch.where(mask, v, fn(torch.where(mask, 0.0, v), D))

    _sync(device)
    t1 = time.perf_counter()
    res = cg(apply_A, b, M=M, rtol=rtol, maxiter=maxiter)
    _sync(device)
    t2 = time.perf_counter()
    err = l2_error(ops, res.x[lat].to(torch.float64), mms_exact)
    return MGSolve(res, float(err), path, op, t1 - t0, t2 - t1)


class OperatorPaths(NamedTuple):
    ndofs: int
    sumfact: SumFactoredOperator
    structured_pa: StructuredPAOperator
    pa: PAOperator
    lat: torch.Tensor  # entity -> lattice: x_lattice[lat] = x_entity
    # name -> (fn, arrays): y = fn(u, *arrays), u and y lattice-numbered
    paths: dict


def operator_paths(n: int = 48, order: int = 2, device=None,
                   dtype=torch.float32) -> OperatorPaths:
    """The apply paths of ``bench.py::bench_operator`` on its form
    ``diffusion(0.1) + convection(beta) + mass(1.0)`` at n^3 elements of
    order ``order`` (1-4), ``SpaceOps(quad_order=2*order)``.

    Each port path stands for these JAX candidates:

    - ``sumfact``: ``bind()``, the plain chain (JAX ``sumfact``);
    - ``sumfact-periodic``: ``bind(use_periodic=True)`` (``sumfact-periodic``);
    - ``sumfact-fused``: ``bind_kernel()``, the element-local kernel on full
      D (``sumfact-fused``, ``-xc2``, ``-s2``, ``sumfact-zfma``);
    - ``sumfact-zfma-periodic``: ``bind_kernel(use_periodic=True)``
      (``sumfact-zfma-periodic``, ``sumfact-fused-periodic``, ``-s4``,
      ``-s2``);
    - ``sumfact-zchain``: ``bind_zchain()``, the z-chain kernel
      (``sumfact-pallas``);
    - ``sumfact-zchain-periodic``: ``bind_zchain(use_periodic=True)``
      (``sumfact-pallas-periodic``);
    - ``structured-pa``: ``StructuredPAOperator`` with the B^T D B kernel
      (``structured-pallas``);
    - ``pa``: ``PAOperator`` with the same kernel, its entity numbering
      moved through ``lat`` (``unstructured-xla``; JAX's PA is XLA there).

    JAX's ``slab``, ``x_chunks`` and ``s2``/``s4`` variants exist only to
    fit the TPU's VMEM, so they are not separate paths here.  The periodic
    paths are present only when D is z-periodic, as in bench.py.
    ``device=None`` means the CUDA device (the kernel paths then launch
    their kernels; on the CPU they run the plain versions)."""
    device = _device(device)
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
    ops = SpaceOps(fes, quad_order=2 * order, device=device,
                   dtype=torch.float64)
    data = (BilinearForm(ops).add_diffusion(0.1).add_convection(BETA)
            .add_mass(1.0).assemble())
    grid = StructuredGrid3D(n, n, n, order)
    sf = SumFactoredOperator(ops, data, n, n, n, order, device=device,
                             dtype=dtype)
    spa = StructuredPAOperator(ops, data, grid, dtype=dtype)
    pa = PAOperator(ops, data, dtype=dtype)
    lat = torch.as_tensor(lattice_index(fes, grid), device=device)
    periodic = sf.z_periodic and sf.compressed
    binds = {"sumfact": sf.bind()}
    if periodic:
        binds["sumfact-periodic"] = sf.bind(use_periodic=True)
    binds["sumfact-fused"] = sf.bind_kernel()
    if periodic:
        binds["sumfact-zfma-periodic"] = sf.bind_kernel(use_periodic=True)
    binds["sumfact-zchain"] = sf.bind_zchain()
    if periodic:
        binds["sumfact-zchain-periodic"] = sf.bind_zchain(use_periodic=True)
    binds["structured-pa"] = spa.bind()
    paths = {name: (fn, (D,)) for name, (fn, D) in binds.items()}
    pa_fn, Dflat, eldofs_T = pa.bind()

    def pa_lattice(u, Dflat, eldofs_T):
        y = pa_fn(u[lat], Dflat, eldofs_T)
        return torch.empty_like(y).index_copy_(0, lat, y)

    paths["pa"] = (pa_lattice, (Dflat, eldofs_T))
    return OperatorPaths(grid.ndofs, sf, spa, pa, lat, paths)


# -- the distributed operator layer ------------------------------------------

def _dryrun_problem(n, order, device, dtype):
    """``__graft_entry__._build_problem``: the CDR step's forms on n^3 hexes
    at ``order`` (quadrature 2p)."""
    fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
    ops = SpaceOps(fes, quad_order=2 * order, device=device, dtype=dtype)
    lhs = (BilinearForm(ops).add_mass(1.0).add_convection(BETA, alpha=DT)
           .add_diffusion(0.1 * DT))
    ldata = lhs.assemble()
    mdata = BilinearForm(ops).add_mass(1.0).assemble()
    bc = EssentialBC(fes.nscalar, fes.boundary_dofs(), device=device)
    return fes, ops, lhs, ldata, mdata, bc, lhs.assemble_diagonal(ldata)


def dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of ``dryrun_multichip``, in a world of ``n_devices`` ranks
    (float32, 4^3 hexes at order 2, as the JAX package's dry run)."""
    from .ops.sumfact_sharded import ShardedSumFactOperator
    from .parallel import (DofPartitionedOperator, ShardedPoissonApply,
                           make_device_mesh)

    mesh = make_device_mesh(n_devices, device=device)
    dev, f32 = mesh.device, torch.float32
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev)}

    # the element-split implicit CDR step, CG as in the JAX dry run
    fes, ops, _, ldata, mdata, bc, diag = _dryrun_problem(4, 2, dev, f32)
    A_sh = ShardedPoissonApply(ops, ldata, mesh)
    M_sh = ShardedPoissonApply(ops, mdata, mesh)
    u0 = torch.zeros(fes.nscalar, dtype=f32, device=dev)
    u0[fes.nscalar // 2] = 1.0
    rhs = M_sh(u0)
    B = bc.constrained_rhs(A_sh, rhs, torch.zeros_like(u0))
    res = cg(bc.constrain_operator(A_sh), B, x0=u0,
             M=jacobi_preconditioner(torch.where(bc.mask, 1.0, diag)),
             rtol=1e-6, maxiter=50)
    if not bool(torch.isfinite(res.x).all()):
        raise RuntimeError("dryrun_multichip: the sharded step is not finite")
    out.update(ndofs=fes.nscalar, step_norm=float(torch.linalg.vector_norm(
        res.x)), step_iters=res.iters)

    # the DOF-partitioned Jacobi-CG against the single-device PA solve
    spd_form = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    spd = spd_form.assemble()
    ddiag = spd_form.assemble_diagonal(spd)
    dop = DofPartitionedOperator(ops, spd, mesh)
    if mesh.size > 1 and dop.per_device_floats() >= fes.nscalar:
        raise RuntimeError("dryrun_multichip: the DOF-partitioned layout is "
                           "not smaller than the global vector")
    bd = torch.as_tensor(np.random.default_rng(1).standard_normal(
        fes.nscalar).astype(np.float32), device=dev)
    dinv = dop.to_dist(1.0 / ddiag)
    resd = cg(dop, dop.to_dist(bd), M=lambda r: dinv * r, rtol=1e-6,
              maxiter=2000, dot=dop.dot, norm=dop.norm)
    pa = PAOperator(ops, spd, dtype=f32)
    ref = cg(pa, bd, M=lambda r: r / ddiag, rtol=1e-6, maxiter=2000)
    xd = dop.from_dist(resd.x)
    reld = float(torch.linalg.vector_norm(xd - ref.x)
                 / torch.linalg.vector_norm(ref.x))
    if not reld < 1e-3:
        raise RuntimeError(f"dryrun_multichip: DOF-partitioned CG is "
                           f"{reld:.3e} from the single-device solve")
    out.update(dofpart_rel=reld, dofpart_iters=resd.iters,
               single_iters=ref.iters, pa_path=pa.path,
               per_device_floats=dop.per_device_floats())

    # the z-split sum-factorized apply against the single-device one
    nz = 2 * mesh.size
    sops = SpaceOps(FESpace(make_cartesian_mesh_3d(4, 4, nz), 2),
                    quad_order=4, device=dev)
    sdata = (BilinearForm(sops).add_diffusion(0.1).add_convection(BETA)
             .add_mass(1.0)).assemble()
    zmesh = make_device_mesh(n_devices, axis="z", device=device)
    shop = ShardedSumFactOperator(sops, sdata, 4, 4, nz, 2, zmesh)
    refop = SumFactoredOperator(sops, sdata, 4, 4, nz, 2, device=dev)
    uu = torch.as_tensor(np.random.default_rng(0).standard_normal(
        refop.ndofs).astype(np.float32), device=dev)
    ys = shop.from_sharded(shop(shop.to_sharded(uu)))
    yr = refop(uu)
    err = float((ys - yr).abs().max() / (yr.abs().max() + 1e-30))
    if not err < 1e-5:
        raise RuntimeError(f"dryrun_multichip: z-split apply is {err:.3e} "
                           "from the single-device apply")
    out.update(sumfact_ndofs=refop.ndofs, sumfact_rel=err)
    return out


def dryrun_multichip(n_devices: int, device=None, timeout: float = 300.0):
    """Run the distributed operator layer once on ``n_devices`` ranks and
    return each rank's record (see ``dryrun_rank``).  ``device="cpu"``
    spawns gloo ranks on the CPU; the default runs one NCCL rank per card
    and raises when there are fewer cards than ranks or no card.  One rank
    with no world yet runs in this process."""
    import torch.distributed as dist

    from .parallel import init_rank, spawn_ranks

    device = _device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip needs >= {n_devices} cards "
                           f"but {torch.cuda.device_count()} exist")
    kind = device.type
    if n_devices == 1 and not dist.is_initialized():
        with tempfile.TemporaryDirectory(prefix="cmfem_ranks_") as tmp:
            init_rank(0, 1, os.path.join(tmp, "store"), device=device,
                      timeout=timeout)
            try:
                return [dryrun_rank(1, str(device))]
            finally:
                dist.destroy_process_group()
    return spawn_ranks(dryrun_rank, n_devices, (n_devices, kind),
                       device=kind, timeout=timeout)
