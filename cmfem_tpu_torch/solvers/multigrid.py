"""Geometric multigrid: ``StructuredMG`` for the structured sum-factorized
operators and ``GeometricMG`` for unstructured meshes.

Port of ``cmfem_tpu/solvers/multigrid.py``.  ``StructuredMG``: on a
tensor-product lattice every multigrid ingredient is a 1D-matrix axis
contraction —

- hierarchy: p-coarsening (order p -> 1 on the same mesh) followed by
  h-coarsening (mesh halving at order 1), every level a
  ``SumFactoredOperator`` (zero gather/scatter);
- transfer: prolongation = linear interpolation of the coarse nodal
  lattice onto the fine lattice, three axis-wise matmuls (restriction is
  the transposed chain);
- smoother: Jacobi-scaled Chebyshev (matmul-only; no triangular solves);
- coarsest level: a high-degree Chebyshev sweep.

The level policy is JAX's: the fine level binds through ``best_bind`` (the
CUDA sum-factorization kernel on a GPU), the coarse levels the plain chain
(``bind()``).

``GeometricMG``: p-coarsening then the driver's own refinement chain, every
level applied through ``BilinearForm.apply``, transfers from point location
(``core.pointlocate.h1_sampling_stencil``): restriction an ``index_add_`` of
the weighted stencil, prolongation a gather and a row sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import FESpace, make_cartesian_mesh_3d
from ..core.pointlocate import h1_sampling_stencil
from ..core.reference_elements import gauss_lobatto_nodes
from ..interop import lattice_diagonal
from ..ops.assembly import SpaceOps
from ..ops.partial import StructuredGrid3D
from ..ops.sumfact import SumFactoredOperator
from .precond import chebyshev_smooth, power_iteration_lmax


def _interp_1d(xc: np.ndarray, xf: np.ndarray) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix from coarse nodes xc to fine
    nodes xf (both ascending, same endpoints)."""
    nf, nc = len(xf), len(xc)
    P = np.zeros((nf, nc))
    j = np.clip(np.searchsorted(xc, xf, side="right") - 1, 0, nc - 2)
    t = (xf - xc[j]) / (xc[j + 1] - xc[j])
    P[np.arange(nf), j] = 1.0 - t
    P[np.arange(nf), j + 1] += t
    return P


def _nodes_1d(nel: int, p: int) -> np.ndarray:
    """The 1D Gauss-Lobatto node lattice of nel elements of order p on
    [0, 1]."""
    base = gauss_lobatto_nodes(p)
    segs = [(e + base) / nel for e in range(nel)]
    return np.concatenate([s[:-1] for s in segs[:-1]] + [segs[-1]])


def _lattice_diag(fes: FESpace, form, data, grid: StructuredGrid3D, *,
                  device, dtype):
    """The operator diagonal, moved from entity numbering to the lattice.

    The JAX package recovers the lattice from the sorted unique node
    coordinates (uniform rounding collides from order 7 up); the port takes
    it from the topology (``interop.lattice_index``), which needs no
    coordinates at all and raises when the space is not the lattice."""
    return lattice_diagonal(form.assemble_diagonal(data), fes, grid,
                            device=device, dtype=dtype)


class GeometricMG:
    """Geometric interpolation multigrid for UNSTRUCTURED meshes: the
    production-PC analog of the reference's PETSc AMG option files for
    the 2D drivers.  The hierarchy is p-coarsening (order -> 1 on the solve
    mesh) followed by the driver's own refinement chain (refined mesh ->
    loaded mesh); transfer operators are exact H1 interpolation stencils of
    each coarse space at the next finer space's node positions
    (``h1_sampling_stencil``), so nested refinement gives the standard
    P / P^T pair without any parent bookkeeping.  Smoothing is
    Jacobi-scaled Chebyshev (matmul-only).

    Levels are dicts fine -> coarse: ``form`` (the level's BilinearForm),
    ``data`` (its OperatorData), ``n``, ``diag`` (1.0 at essential dofs),
    ``mask``, ``lmax`` and, for every level but the coarsest, ``Pd``
    (nf, nd) int64 and ``Pw`` (nf, nd): the coarse DOFs and weights that
    interpolate to each fine DOF.
    """

    def __init__(self, levels, smooth_degree: int = 3,
                 coarse_degree: int = 24):
        self.levels = levels
        self.smooth_degree = smooth_degree
        self.coarse_degree = coarse_degree

    @staticmethod
    def build(specs, make_form, quad_order=None, ess_dofs=None, *, device,
              dtype=torch.float64,
              generator: torch.Generator | None = None):
        """specs: list of (mesh, order) fine -> coarse (nested domains:
        every finer level's nodes must lie inside the coarser mesh).
        ``make_form(ops) -> BilinearForm`` defines the SPD PDE on every
        level (``ops`` lives on ``device`` in ``dtype``).
        ``ess_dofs(fes) -> index array`` selects each level's essential
        dofs (default: the full boundary).  The PC's pinned set must match
        the SYSTEM's essential dofs: a PC that pins dofs the system leaves
        free (e.g. full boundary vs x-only Dirichlet in the 3-Peclet
        driver) acts as identity there and can stall GMRES into a silently
        wrong iterate.  ``generator`` draws the power iterations' start
        vectors (default: seeded with 0)."""
        device = torch.device(device)
        levels = []
        prev_fes = None
        for (mesh_l, order_l) in specs:
            fes = FESpace(mesh_l, order_l)
            ops = SpaceOps(fes, quad_order=quad_order or max(2, 2 * order_l),
                           device=device, dtype=dtype)
            form = make_form(ops)
            data = form.assemble()
            mask = np.zeros(fes.nscalar, bool)
            ess_l = (fes.boundary_dofs() if ess_dofs is None
                     else ess_dofs(fes))
            mask[np.asarray(ess_l)] = True
            mask = torch.as_tensor(mask, device=device)
            lvl = {
                "form": form,
                "data": data,
                "n": fes.nscalar,
                "diag": torch.where(mask, 1.0, form.assemble_diagonal(data)),
                "mask": mask,
            }
            if prev_fes is not None:
                # interpolation of THIS (coarse) space at the previous
                # (fine) level's nodes: u_f = P u_c
                pd, pw = h1_sampling_stencil(
                    fes, np.asarray(prev_fes.node_positions))
                if not np.isfinite(pw).all():
                    raise ValueError(
                        "GeometricMG: fine nodes fall outside the coarse "
                        "mesh (non-nested hierarchy)")
                levels[-1]["Pd"] = torch.as_tensor(pd, device=device)
                levels[-1]["Pw"] = torch.as_tensor(pw, dtype=dtype,
                                                   device=device)
            levels.append(lvl)
            prev_fes = fes

        # Chebyshev eigenvalue estimates of the Jacobi-scaled constrained
        # operators
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for lvl in levels:
            form, data = lvl["form"], lvl["data"]
            mask = lvl["mask"]
            dinv = 1.0 / lvl["diag"]

            def Aop(v, form=form, data=data, mask=mask, dinv=dinv):
                av = form.apply(data, torch.where(mask, 0.0, v))
                return dinv * torch.where(mask, v, av)

            lvl["lmax"] = float(power_iteration_lmax(
                Aop, lvl["n"], iters=20, generator=generator, device=device,
                dtype=dtype)) * 1.05
        return GeometricMG(levels)

    def bind(self):
        """(M(r, arrays), arrays): the V-cycle preconditioner, with every
        level's (data, diag, mask, Pd, Pw) passed as arguments."""
        nlev = len(self.levels)
        forms = [lvl["form"] for lvl in self.levels]
        meta = [{"lmax": lvl["lmax"], "n": lvl["n"]} for lvl in self.levels]
        arrays = []
        for lvl in self.levels:
            dev, dtype = lvl["diag"].device, lvl["diag"].dtype
            arrays.append((lvl["data"], lvl["diag"], lvl["mask"],
                           lvl.get("Pd", torch.zeros((0, 1), dtype=torch.int64,
                                                     device=dev)),
                           lvl.get("Pw", torch.zeros((0, 1), dtype=dtype,
                                                     device=dev))))
        smooth_degree = self.smooth_degree
        coarse_degree = self.coarse_degree

        def apply_level(k, v, arrs):
            data, _, mask, _, _ = arrs[k]
            av = forms[k].apply(data, torch.where(mask, 0.0, v))
            return torch.where(mask, v, av)

        def chebyshev(k, r, arrs, degree):
            dinv = 1.0 / arrs[k][1]

            def Aop(v):
                return dinv * apply_level(k, v, arrs)

            return chebyshev_smooth(Aop, dinv * r, meta[k]["lmax"], degree)

        def restrict(k, r, arrs):
            """fine k -> coarse k+1 via P^T (scatter of the stencil)."""
            _, _, _, Pd, Pw = arrs[k]
            rc = torch.zeros(meta[k + 1]["n"], dtype=r.dtype, device=r.device)
            rc.index_add_(0, Pd.reshape(-1), (Pw * r[:, None]).reshape(-1))
            return torch.where(arrs[k + 1][2], 0.0, rc)

        def prolong(k, e, arrs):
            _, _, _, Pd, Pw = arrs[k]
            ef = (Pw * e[Pd]).sum(1)
            return torch.where(arrs[k][2], 0.0, ef)

        def vcycle(k, r, arrs):
            if k == nlev - 1:
                return chebyshev(k, r, arrs, coarse_degree)
            z = chebyshev(k, r, arrs, smooth_degree)
            res = r - apply_level(k, z, arrs)
            ec = vcycle(k + 1, restrict(k, res, arrs), arrs)
            z = z + prolong(k, ec, arrs)
            res = r - apply_level(k, z, arrs)
            z = z + chebyshev(k, res, arrs, smooth_degree)
            return z

        def M(r, arrs):
            return vcycle(0, r, arrs)

        return M, tuple(arrays)


class StructuredMG:
    """V-cycle preconditioner over a list of structured-lattice levels.

    Levels are ordered fine -> coarse.  Each level dict carries ``op`` (its
    SumFactoredOperator), ``shape`` (NZ, NY, NX), ``diag`` (lattice
    diagonal with 1.0 at essential dofs), ``mask`` (bool essential-dof
    mask), ``lmax`` (top eigenvalue estimate of the Jacobi-scaled
    constrained operator, times 1.05) and, for every level but the
    coarsest, ``P1``: the 1D prolongation matrix from the next coarser
    lattice (the same in x, y and z)."""

    def __init__(self, levels, smooth_degree: int = 3,
                 coarse_degree: int = 24):
        self.levels = levels
        self.smooth_degree = smooth_degree
        self.coarse_degree = coarse_degree
        self.fine_path = None  # the fine level's apply path, set by bind()

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(n, order, make_form, *, device, dtype=torch.float32,
              generator: torch.Generator | None = None):
        """Build the level hierarchy for an (n, n, n) cartesian mesh at
        ``order``: p-coarsen to order 1, then h-coarsen while n is even and
        the coarse mesh keeps at least 2 elements per axis.
        ``make_form(ops) -> BilinearForm`` defines the PDE on every level;
        it is assembled in float64 on ``device`` (quadrature order
        max(2, 2p)) and the operators are cast to ``dtype``.  Every
        boundary DOF is essential.  ``generator`` draws the power
        iterations' start vectors (default: seeded with 0)."""
        device = torch.device(device)
        specs = [(n, order)]
        pl = order
        while pl > 1:
            pl = max(1, pl // 2)
            specs.append((n, pl))
        nn = n
        while nn % 2 == 0 and nn // 2 >= 2:
            nn //= 2
            specs.append((nn, 1))

        levels = []
        prev = None
        for (nl, pl) in specs:
            fes = FESpace(make_cartesian_mesh_3d(nl, nl, nl), pl)
            ops = SpaceOps(fes, quad_order=max(2, 2 * pl), device=device,
                           dtype=torch.float64)
            form = make_form(ops)
            data = form.assemble()
            op = SumFactoredOperator(ops, data, nl, nl, nl, pl, device=device,
                                     dtype=dtype)
            grid = StructuredGrid3D(nl, nl, nl, pl)
            diag = _lattice_diag(fes, form, data, grid, device=device,
                                 dtype=dtype)
            del data, form, ops
            mask = torch.as_tensor(grid.boundary_mask(), device=device)
            lvl = {
                "op": op,
                "shape": (op.NZ, op.NY, op.NX),
                "diag": torch.where(mask, 1.0, diag),
                "mask": mask,
            }
            if prev is not None:
                P = _interp_1d(_nodes_1d(nl, pl), _nodes_1d(*prev))
                levels[-1]["P1"] = torch.as_tensor(P, dtype=dtype,
                                                   device=device)
            levels.append(lvl)
            prev = (nl, pl)

        # eigenvalue estimates for the Chebyshev smoothers (plain chains)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for lvl in levels:
            fn, D = lvl["op"].bind()
            mask = lvl["mask"]
            dinv = 1.0 / lvl["diag"]

            def Aop(v, fn=fn, D=D, mask=mask, dinv=dinv):
                av = fn(torch.where(mask, 0.0, v), D)
                return dinv * torch.where(mask, v, av)

            lvl["lmax"] = float(power_iteration_lmax(
                Aop, lvl["diag"].shape[0], iters=20, generator=generator,
                device=device, dtype=dtype)) * 1.05
        return StructuredMG(levels)

    # -- binding ------------------------------------------------------------

    def bind(self):
        """(M(r, arrays), arrays): the V-cycle preconditioner, with every
        level's operator data passed as arguments.  Sets ``fine_path`` to
        the path ``best_bind`` chose for the fine level."""
        fns, meta, arrays = [], [], []
        for k, lvl in enumerate(self.levels):
            # the V-cycle spends ~8 fine-level applies per iteration in the
            # smoothers, so the fine level takes its fastest path; the
            # coarse levels keep the plain chain, as in the JAX package
            if k == 0:
                fn, D, self.fine_path = lvl["op"].best_bind()
            else:
                fn, D = lvl["op"].bind()
            fns.append(fn)
            P1 = lvl.get("P1", torch.zeros(0, device=lvl["diag"].device))
            arrays.append((D, lvl["diag"], lvl["mask"], P1))
            meta.append({"shape": lvl["shape"], "lmax": lvl["lmax"]})
        nlev = len(self.levels)
        smooth_degree = self.smooth_degree
        coarse_degree = self.coarse_degree

        def apply_level(k, v, arrs):
            D, _, mask, _ = arrs[k]
            av = fns[k](torch.where(mask, 0.0, v), D)
            return torch.where(mask, v, av)

        def chebyshev(k, r, arrs, degree):
            """z ~= A_k^{-1} r via Jacobi-scaled Chebyshev, z0 = 0."""
            dinv = 1.0 / arrs[k][1]

            def Aop(v):
                return dinv * apply_level(k, v, arrs)

            return chebyshev_smooth(Aop, dinv * r, meta[k]["lmax"], degree)

        def restrict(k, r, arrs):
            """fine level k -> coarse level k+1 (P^T along each axis)."""
            P = arrs[k][3]  # (Nf, Nc)
            r3 = r.reshape(meta[k]["shape"])
            t = torch.einsum("fc,zyf->zyc", P, r3)
            t = torch.einsum("fc,zfx->zcx", P, t)
            t = torch.einsum("fc,fyx->cyx", P, t)
            return torch.where(arrs[k + 1][2], 0.0, t.reshape(-1))

        def prolong(k, e, arrs):
            """coarse level k+1 -> fine level k."""
            P = arrs[k][3]
            e3 = e.reshape(meta[k + 1]["shape"])
            t = torch.einsum("fc,zyc->zyf", P, e3)
            t = torch.einsum("fc,zcx->zfx", P, t)
            t = torch.einsum("fc,cyx->fyx", P, t)
            return torch.where(arrs[k][2], 0.0, t.reshape(-1))

        def vcycle(k, r, arrs):
            if k == nlev - 1:
                return chebyshev(k, r, arrs, coarse_degree)
            z = chebyshev(k, r, arrs, smooth_degree)
            res = r - apply_level(k, z, arrs)
            ec = vcycle(k + 1, restrict(k, res, arrs), arrs)
            z = z + prolong(k, ec, arrs)
            res = r - apply_level(k, z, arrs)
            z = z + chebyshev(k, res, arrs, smooth_degree)
            return z

        def M(r, arrs):
            return vcycle(0, r, arrs)

        return M, tuple(arrays)
