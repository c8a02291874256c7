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

The distributed layer, ``dryrun_multichip(n_devices)``: the counterpart
of ``__graft_entry__.dryrun_multichip``: an implicit CDR step through
``ShardedPoissonApply`` and CG, a Jacobi-CG solve on
``DofPartitionedOperator`` against the single-device PA solve, the z-split
sum-factorized apply against ``SumFactoredOperator``, and the ablation
sections (``dryrun_ablation_rank``: the element-sharded and the
DOF-partitioned ablation Newton, static and on a receded case-2.2 mesh).
On the CPU it spawns ``n_devices`` gloo ranks; on the card one NCCL rank
per card.
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
    out.update(dryrun_ablation_rank(n_devices, device))
    return out


TACOT_DECK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "tacot_synthetic.json")


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def dryrun_ablation_rank(n_devices: int, device, deck: str = TACOT_DECK):
    """The ablation sections of ``dryrun_multichip``, on this rank of a
    world of ``n_devices`` (float64; the JAX package's dry run skips them
    off the CPU, since the TPU has no float64): on a 2 x ``n_devices`` strip
    of the TACOT deck ``deck`` (the repo's synthetic one by default) with
    the wall at 900 K,

    - two ``ShardedAblationNewton`` iterates: the residual norm falls;
    - one ``DofPartitionedAblationNewton`` iterate from the same state,
      equal to the first element-sharded one to 1e-6 relative, with fewer
      floats per rank than the replicated vectors (from three ranks on: on
      two, the 2 x 2 strip's halo row makes the layouts equal);
    - a case-2.2 iterate on a receded mesh with an ALE mesh velocity and
      SEB faces (synthetic B' table), DOF-partitioned against
      element-sharded, to 1e-6 (iterate and residual norm).

    Only ``all_reduce`` and ``all_gather`` run: gloo carries it on CUDA
    tensors.  Returns the record of this rank."""
    from .core import make_cartesian_mesh_2d
    from .parallel import (DofPartitionedAblationNewton,
                           ShardedAblationNewton, make_device_mesh)
    from .physics.ablation import AblationState, AblationSystem
    from .physics.bprime import BPrimeTable
    from .physics.seb import SurfaceFluxModel, classify_branch
    from .physics.surface_bc import BoundaryState
    from .physics.tacot import TacotMaterial

    mesh = make_device_mesh(n_devices, device=device)
    dev, f64 = mesh.device, torch.float64
    amesh = make_cartesian_mesh_2d(2, n_devices, sx=0.0025, sy=0.05)
    afes = FESpace(amesh, 1)
    an = afes.nscalar
    aops = SpaceOps(afes, quad_order=4, device=dev, dtype=f64)
    asys = AblationSystem(aops, TacotMaterial.load_yaml(deck), top_attr=3)
    astate = AblationState.initial(asys.ne, asys.nq, asys.mat, device=dev)
    ess = np.asarray(afes.boundary_dofs([3]))
    ess_t = torch.as_tensor(ess, device=dev)
    T = torch.full((an,), 300.0, dtype=f64, device=dev)
    T[ess_t] = 900.0
    p = torch.full((an,), 101325.0, dtype=f64, device=dev)
    To_q = aops.values_at_qp(torch.full_like(T, 300.0))
    po_q = aops.values_at_qp(p)
    out = {"ablation_dofs": 2 * an}

    # the element-sharded Newton iterate, twice
    sh = ShardedAblationNewton(asys, mesh, ess, ess, restart=100,
                               maxiter=10)
    To, po, Xo = (sh.pad_elem(a) for a in (To_q, po_q, astate.extent))
    T1, p1, r0, _ = sh.newton_step(T, p, To, po, Xo, 0.05, rtol=1e-10)
    _, _, r1, _ = sh.newton_step(T1, p1, To, po, Xo, 0.05, rtol=1e-10)
    r0, r1 = float(r0), float(r1)
    if not (math.isfinite(r0) and math.isfinite(r1) and r1 < r0):
        raise RuntimeError(f"dryrun_multichip: the sharded ablation Newton "
                           f"does not converge (|R0| {r0:.3e}, |R1| "
                           f"{r1:.3e})")
    out.update(ablation_sharded_r0=r0, ablation_sharded_r1=r1)

    # the DOF-partitioned iterate against it
    dn = DofPartitionedAblationNewton(asys, mesh, ess, ess, restart=100,
                                      maxiter=10)
    Tod, pod, Xod = (dn.pack_elem(a, "dup")
                     for a in (To_q, po_q, astate.extent))
    y1, _, _ = dn.newton_step(dn.to_dist2(T, p), Tod, pod, Xod, 0.05,
                              rtol=1e-10)
    T1d, p1d = dn.gather2(y1)
    rel = max(_rel_max(T1d, T1), _rel_max(p1d, p1))
    floats = dn.per_device_floats()
    if not rel < 1e-6 or (mesh.size > 2 and not floats < 2 * an):
        raise RuntimeError(f"dryrun_multichip: the DOF-partitioned ablation "
                           f"iterate is {rel:.3e} from the element-sharded "
                           f"one ({floats} floats per rank, {2 * an} "
                           f"replicated)")
    out.update(ablation_dofpart_rel=rel, ablation_per_device_floats=floats)

    # the case-2.2 iterate: receded vertices, ALE mesh velocity, SEB faces
    model = SurfaceFluxModel(case22=True)
    bcs = BoundaryState(p_w=101325.0, rhoeUeCH=0.3, h_r=1.5e6, hconv=0.0,
                        Tedge=300.0, has_hconv=False, has_Tedge=False,
                        chemistryOn=1)
    seb = (classify_branch(bcs, model), model, BPrimeTable.synthetic_tacot())
    verts1 = np.asarray(amesh.vertices, dtype=np.float64).copy()
    verts1[:, 1] *= 1.0 - 0.02 * (verts1[:, 1] / verts1[:, 1].max())
    verts1 = torch.as_tensor(verts1, device=dev)
    wq = torch.zeros((asys.ne, asys.nq, 2), dtype=f64, device=dev)
    wq[:, :, 1] = -1e-5
    no_T = np.zeros(0, dtype=np.int64)
    sh22 = ShardedAblationNewton(asys, mesh, no_T, ess, restart=100,
                                 maxiter=10, seb=seb)
    sh22.update_geometry(verts1)
    dn22 = DofPartitionedAblationNewton(asys, mesh, no_T, ess, restart=100,
                                        maxiter=10, seb=seb)
    dn22.update_geometry(verts1)
    T1s, p1s, rs0, _ = sh22.newton_step(T, p, To, po, Xo, 0.05, rtol=1e-10,
                                        bc=bcs, wq=sh22.pad_elem(wq))
    y1d, rd0, _ = dn22.newton_step(dn22.to_dist2(T, p), Tod, pod, Xod, 0.05,
                                   rtol=1e-10, bc=bcs,
                                   wq=dn22.pack_elem(wq, "zero"))
    T2d, p2d = dn22.gather2(y1d)
    rel2 = max(_rel_max(T2d, T1s), _rel_max(p2d, p1s))
    dr = abs(float(rs0) - float(rd0)) / float(rs0)
    if not (rel2 < 1e-6 and dr <= 1e-6):
        raise RuntimeError(f"dryrun_multichip: the case-2.2 DOF-partitioned "
                           f"iterate is {rel2:.3e} from the element-sharded "
                           f"one (|R0| {dr:.3e} apart)")
    out.update(ablation_case22_rel=rel2, ablation_case22_r0=float(rs0),
               ablation_case22_r0_rel=dr)
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
