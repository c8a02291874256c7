"""Moving-mesh (ALE) recession machinery.

Port of ``cmfem_tpu/motion/recession.py`` (the reference
``MeshRecessionHandler``, mesh_recession_handler.{hpp,cpp}):

- top/bottom boundary DOF maps (:63-154);
- per-step clamping of the top recession velocity by max_step_recession/dt
  and non-negativity (:156-188);
- vector-Laplacian mesh-velocity smoothing with Dirichlet (0, -v_top) on
  the top and 0 on the bottom, CG rtol 1e-12 (:219-279): the vector
  Laplacian with unit coefficient decouples into per-component scalar
  solves, and only the recession axis carries a non-zero one;
- two-phase prepare/commit so the ALE state remap can run between the
  velocity computation and the node move (:322-375);
- element-quality guard by the min detJ ratio against the initial mesh
  (:302-320).

The vertices, the clamp, the pending/commit protocol and the bookkeeping
stay on the host (numpy), as in the JAX package; the quality metric, the
Laplacian assembly and the cold-started CG run on the device of ``device``.
Works on order-1 nodal meshes (scalar DOFs == vertices), which is what
every reference recession configuration uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fespace import FESpace
from ..core.geometry import compute_geometric_factors
from ..core.quadrature import gauss_rule
from ..core.reference_elements import get_reference_element
from ..ops.assembly import BilinearForm, SpaceOps
from ..ops.bc import EssentialBC
from ..solvers import cg, jacobi_preconditioner
from ..utils.timing import host_copy, host_sync, span_count


def quality_tables(mesh, device, dtype=torch.float64):
    """The order-2 quality rule's tabulations (reference :308):
    (Bg, Gg, weights, conn) as tensors on ``device``."""
    q = gauss_rule(mesh.geom, 2)
    Bg, Gg = get_reference_element(mesh.geom, 1).eval(q.points)
    real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device)
    return (real(Bg), real(Gg), real(q.weights),
            torch.as_tensor(np.asarray(mesh.elem_conn, dtype=np.int64),
                            device=device))


def min_quality(tables, verts):
    """min detJ over the quality rule's points (a 0-d tensor) of the
    vertex tensor ``verts`` (nv, dim)."""
    Bg, Gg, w, conn = tables
    return torch.min(compute_geometric_factors(verts[conn], Bg, Gg, w).detJ)


def smoothing_rtol(dtype):
    """The smoothing CG's relative tolerance: the reference's 1e-12
    (mesh_recession_handler.cpp:270-276) floored at 50 eps of the working
    precision (1e-12 is unreachable in float32)."""
    return max(1e-12, 50.0 * float(torch.finfo(dtype).eps))


class LaplacianSmoother:
    """The recession-axis component of the smoothed mesh velocity: the
    scalar Laplacian on the current geometry with -v on the top DOFs and 0
    on the bottom ones, Jacobi-CG at ``smoothing_rtol``, maxiter 500, run
    to its tolerance or its cap as MFEM's CGSolver runs it: without the
    CG's flat-window and detachment exits (``stall_window=0``), which stop
    it on the deck's 11 x 239 strip after ~80 iterations at a relative
    residual ~8e-3, where it converges in ~340."""

    def __init__(self, fes: FESpace, top_dofs, bottom_dofs, *, device,
                 dtype=torch.float64):
        self.n = fes.nscalar
        # a fixed-order scatter: with index_add_'s atomics the repeats of a
        # solve on the card differed at the ulp level (ROADMAP C10)
        self.ops = SpaceOps(fes, device=device, dtype=dtype)
        self.ops.fix_scatter_order()
        self.form = BilinearForm(self.ops).add_diffusion(1.0)
        self.bc = EssentialBC(self.n, np.unique(np.concatenate(
            [top_dofs, bottom_dofs])), device=device)
        self.top = torch.as_tensor(np.asarray(top_dofs, dtype=np.int64),
                                   device=device)

    def solve(self, verts, v_top, x0=None):
        """The CG result for vertices ``verts`` (nv, dim) and the clamped
        top velocity ``v_top`` (n,) (both tensors); ``x0`` warm-starts the
        iteration (its top DOFs are set to -v).  Counts its iterations as
        ``mesh_cg_iters`` on the timer whose span is open."""
        data = self.form.assemble(self.ops.geometric_factors(verts))
        apply_A = lambda u: self.form.apply(data, u)
        diag = torch.where(self.bc.mask, 1.0,
                           self.form.assemble_diagonal(data))
        u_bc = torch.zeros_like(v_top)
        u_bc[self.top] = -v_top[self.top]
        B = self.bc.constrained_rhs(apply_A, torch.zeros_like(v_top), u_bc)
        if x0 is not None:
            x0 = x0.clone()
            x0[self.top] = -v_top[self.top]
        res = cg(self.bc.constrain_operator(apply_A), B, x0=x0,
                 M=jacobi_preconditioner(diag),
                 rtol=smoothing_rtol(B.dtype), maxiter=500,
                 stall_window=0)
        span_count("mesh_cg_iters", res.iters)
        return res


class MeshRecessionHandler:
    def __init__(self, mesh, fes: FESpace, bdr_attr_top=1, bdr_attr_bottom=2,
                 max_step_recession=float("inf"), min_quality_ratio=0.05,
                 recession_axis: int | None = None, *, device,
                 dtype=torch.float64):
        if fes.order != 1:
            raise NotImplementedError(
                "MeshRecessionHandler requires an order-1 nodal mesh")
        self.mesh = mesh
        self.fes = fes
        self.n = fes.nscalar
        self.device, self.dtype = torch.device(device), dtype
        # the surface-normal axis the wall recedes along (reference: +y in
        # 2D; +z for 3D slabs).  Defaults to the last coordinate.
        self.axis = mesh.dim - 1 if recession_axis is None else recession_axis
        self.max_step_recession = max_step_recession
        self.min_quality_ratio = min_quality_ratio
        self.top_dofs = np.asarray(fes.boundary_dofs([bdr_attr_top]))
        self.bottom_dofs = np.asarray(fes.boundary_dofs([bdr_attr_bottom]))
        self.vertices = np.asarray(mesh.vertices, dtype=np.float64).copy()
        self.total_recession = 0.0
        self.mesh_velocity = np.zeros((self.n, mesh.dim))
        self._pending_dt = 0.0
        self._pending_mean_v = 0.0

        self._qual = quality_tables(mesh, self.device, dtype)
        self.initial_min_quality = self._min_quality()
        if not np.isfinite(self.initial_min_quality) or \
                self.initial_min_quality <= 0:
            raise RuntimeError(
                "Invalid initial mesh quality for moving-mesh recession.")
        self._smoother = None

    def _tensor(self, a):
        host_copy(a, self.device)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def restore(self, vertices, total_recession: float):
        """Resume from a checkpoint: set the receded node positions and the
        cumulative recession.  The quality baseline stays the pristine mesh
        (same as a straight-through run).  Raises if the restored mesh
        violates the quality guard."""
        vertices = np.asarray(vertices, dtype=np.float64)
        if vertices.shape != self.vertices.shape:
            raise ValueError(
                f"Restored vertex shape {vertices.shape} != mesh "
                f"{self.vertices.shape}")
        self.vertices = vertices.copy()
        self.total_recession = float(total_recession)
        q = self._min_quality()
        if q <= 0 or q / self.initial_min_quality < self.min_quality_ratio:
            raise RuntimeError(
                "Restored mesh violates the quality guard.")

    def _min_quality(self, vertices=None) -> float:
        verts = self.vertices if vertices is None else vertices
        q = min_quality(self._qual, self._tensor(verts))
        host_sync()
        return float(q)

    def clamp_top_velocity(self, v_top, dt):
        """Non-negative, <= max_step_recession/dt, only at top dofs."""
        v = np.zeros(self.n)
        if torch.is_tensor(v_top):
            host_sync()
            vin = v_top.detach().cpu().numpy()
        else:
            vin = np.asarray(v_top)
        vmax = np.inf
        if np.isfinite(self.max_step_recession) and \
                self.max_step_recession > 0 and dt > 0:
            vmax = self.max_step_recession / dt
        vt = vin[self.top_dofs]
        vt = np.where(np.isfinite(vt) & (vt > 0), vt, 0.0)
        if np.isfinite(vmax):
            vt = np.minimum(vt, vmax)
        v[self.top_dofs] = vt
        return v

    def prepare_advance(self, v_top, dt):
        """Compute the mesh velocity (Laplacian smoothing) without moving
        the mesh; returns the (n, dim) nodal mesh-velocity field."""
        self._pending_dt = dt
        self._pending_mean_v = 0.0
        self.mesh_velocity[:] = 0.0
        if dt <= 0 or v_top is None:
            return self.mesh_velocity
        vc = self.clamp_top_velocity(v_top, dt)
        self._pending_mean_v = float(vc[self.top_dofs].mean()) \
            if len(self.top_dofs) else 0.0
        if self._pending_mean_v <= 0:
            return self.mesh_velocity
        # scalar Laplacian on the CURRENT geometry (the tabulations are
        # static: built once); tangential components solve to zero
        if self._smoother is None:
            self._smoother = LaplacianSmoother(
                self.fes, self.top_dofs, self.bottom_dofs,
                device=self.device, dtype=self.dtype)
        res = self._smoother.solve(self._tensor(self.vertices),
                                   self._tensor(vc))
        if not res.converged:
            print(f"WARNING: mesh-velocity CG stalled at residual "
                  f"{res.residual:.3e} after {res.iters} "
                  "iterations; committing the last iterate.")
        host_sync()
        self.mesh_velocity[:, self.axis] = res.x.cpu().numpy()
        return self.mesh_velocity

    def commit_advance(self):
        """Move the nodes, update recession bookkeeping, guard quality.

        The quality guard runs on the CANDIDATE geometry before anything
        is committed: a guard failure raises with the handler still on
        the pre-step mesh and the pending state cleared, so a driver can
        catch and retry (e.g. with a smaller dt) from a consistent
        state."""
        out = {"delta_recession": 0.0, "max_node_disp": 0.0,
               "total_recession": self.total_recession, "min_quality": 1.0}
        moved = self._pending_mean_v > 0 and self._pending_dt > 0
        cand = self.vertices
        if moved:
            disp = self._pending_dt * self.mesh_velocity
            cand = self.vertices + disp
            out["max_node_disp"] = float(np.abs(disp).max())

        q = self._min_quality(cand)
        ratio = q / self.initial_min_quality
        out["min_quality"] = ratio
        if q <= 0 or ratio < self.min_quality_ratio:
            self._pending_dt = 0.0
            self._pending_mean_v = 0.0
            if q <= 0:
                raise RuntimeError(
                    "Mesh quality failure: non-positive element Jacobian "
                    "detected.")
            raise RuntimeError(
                "Mesh quality ratio below configured minimum threshold.")

        if moved:
            self.vertices = np.asarray(cand)
            delta = self._pending_mean_v * self._pending_dt
            self.total_recession += delta
            out["delta_recession"] = delta
        out["total_recession"] = self.total_recession
        self._pending_dt = 0.0
        self._pending_mean_v = 0.0
        return out

    def mesh_velocity_at_qp(self, ops: SpaceOps):
        """(ne, nq, dim) mesh velocity interpolated to quadrature points,
        a tensor on the device of ``ops``."""
        host_copy(self.mesh_velocity, ops.device)
        w = torch.as_tensor(self.mesh_velocity, dtype=ops.dtype,
                            device=ops.device)
        return torch.einsum("qn,end->eqd", ops.B, w[ops.eldofs])
