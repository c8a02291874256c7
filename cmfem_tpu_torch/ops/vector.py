"""Vector-valued H1 forms: elasticity and vector diffusion.

Port of ``cmfem_tpu/ops/vector.py``: the reference's
``VectorDiffusionIntegrator`` (mesh-velocity Laplacian,
mesh_recession_handler.cpp:229) and the BASELINE config #5 linear-elasticity
path (vector H1, order 2, cantilever + CG/Jacobi).

DOF layout is byNODES: component c of scalar dof i lives at c*nscalar + i
(FESpace.vdof).  The quadrature-point stiffness C is (ne, nq, v, d, v, d);
applies are einsums and a scatter of the element contributions.

The scatter (``jax.ops.segment_sum`` in the JAX package) is a gather of
each DOF's element slots in a fixed order and a sum over them, not an
``index_add_``: on the GPU the atomics of ``index_add_`` add in an order that
changes from run to run, and Jacobi-CG on the slender cantilevers of the
elasticity driver follows that roundoff.  With the atomics about one solve
in six of the 2D default stopped on CG's detachment exit at relative
residual 0.8 (H100, PERF.md); with this scatter every run is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import SpaceOps, dof_slots, eval_coefficient


def _scatter_components(y_e, slots):
    """(ne, nd, v) element contributions -> (v*n,) byNODES global vector,
    summed over ``dof_slots`` in a fixed order."""
    v = y_e.shape[-1]
    rows = torch.cat([y_e.reshape(-1, v), y_e.new_zeros((1, v))])
    return rows[slots].sum(dim=1).T.reshape(-1)


class VectorBilinearForm:
    """Sum of vector-valued domain integrators on a vdim=dim H1 space."""

    def __init__(self, ops: SpaceOps, vdim: int | None = None):
        self.ops = ops
        self.dim = ops.G.shape[-1]
        self.vdim = vdim or self.dim
        self.n = ops.fes.nscalar
        self._parts = []  # callables gf -> qp tensor C (ne, nq, v, d, v, d)
        self._slots = dof_slots(ops.eldofs, self.n)

    def add_vector_diffusion(self, coeff=1.0, time=None):
        """(c grad u_v, grad v_v) componentwise — VectorDiffusionIntegrator."""

        def build(gf):
            c = eval_coefficient(coeff, gf.xq, time) * gf.wdetJ
            eye = lambda k: torch.eye(k, dtype=c.dtype, device=c.device)
            # C[v,d,w,e] = c delta_vw delta_de (physical-gradient space)
            return torch.einsum("aq,vw,de->aqvdwe", c, eye(self.vdim),
                                eye(self.dim))

        self._parts.append(build)
        return self

    def add_elasticity(self, lam=1.0, mu=1.0, time=None):
        """(C eps(u), eps(v)) with isotropic stiffness:
        sigma = lam tr(eps) I + 2 mu eps  — ElasticityIntegrator."""

        def build(gf):
            lam_q = eval_coefficient(lam, gf.xq, time) * gf.wdetJ
            mu_q = eval_coefficient(mu, gf.xq, time) * gf.wdetJ
            I = torch.eye(self.dim, dtype=lam_q.dtype, device=lam_q.device)
            # bilinear density: lam (div u)(div v) + 2 mu eps(u):eps(v)
            # C[v,a,w,b] acting grad(u)[w,b] -> weight for grad(v)[v,a]
            C_lam = torch.einsum("va,wb->vawb", I, I)
            C_mu = 0.5 * (torch.einsum("vw,ab->vawb", I, I)
                          + torch.einsum("vb,aw->vawb", I, I)) * 2.0
            return (lam_q[..., None, None, None, None] * C_lam
                    + mu_q[..., None, None, None, None] * C_mu)

        self._parts.append(build)
        return self

    def assemble(self, gf=None):
        gf = gf or self.ops.gf
        C = None
        for p in self._parts:
            t = p(gf)
            C = t if C is None else C + t
        return C

    def _grads(self, u, gf):
        """Physical gradients of each component: (ne, nq, vdim, dim)."""
        ops = self.ops
        u_e = u.reshape(self.vdim, self.n)[:, ops.eldofs]  # (v, ne, nd)
        gref = torch.einsum("qnr,ven->eqvr", ops.G, u_e)
        return torch.sum(gf.invJ[:, :, None, :, :] * gref[..., :, None],
                         dim=-2)

    def apply(self, C, u, gf=None):
        """Matrix-free A u for the assembled QP stiffness C."""
        ops = self.ops
        gf = gf or ops.gf
        gu = self._grads(u, gf)  # (ne, nq, v, d)
        W = torch.einsum("aqvdwe,aqwe->aqvd", C, gu)
        # pull back to reference gradients and scatter per component
        Wref = torch.sum(gf.invJ[:, :, None, :, :] * W[:, :, :, None, :],
                         dim=-1)
        y_e = torch.einsum("qnr,eqvr->env", ops.G, Wref)
        return _scatter_components(y_e, self._slots)

    def assemble_diagonal(self, C, gf=None):
        ops = self.ops
        gf = gf or ops.gf
        # diag over components: D[c, i] = sum_q Gphys[q,i,:] C[c,:,c,:] Gphys[q,i,:]
        Gphys = torch.einsum("mqrd,qnr->mqnd", gf.invJ, ops.G)
        d_e = torch.stack(
            [torch.einsum("mqnd,mqdc,mqnc->mn", Gphys, C[:, :, c, :, c, :],
                          Gphys) for c in range(self.vdim)], dim=-1)
        return _scatter_components(d_e, self._slots)


def _vector_values(f, pts, time, vdim, shape):
    """A vector load f(x[, t]) -> (..., vdim) at points (npts, dim), on the
    points' device and dtype (f may return a numpy array or a tensor)."""
    vals = f(pts) if time is None else f(pts, time)
    if not torch.is_tensor(vals):
        vals = np.asarray(vals)
    return torch.as_tensor(vals, dtype=pts.dtype,
                           device=pts.device).reshape(shape + (vdim,))


def vector_domain_lf(ops: SpaceOps, f, vdim=None, time=None, gf=None):
    """(f, v) with a vector load f(x) -> (..., vdim)."""
    gf = gf or ops.gf
    vdim = vdim or ops.G.shape[-1]
    flat = gf.xq.reshape(-1, gf.xq.shape[-1])
    fq = _vector_values(f, flat, time, vdim, tuple(gf.xq.shape[:-1]))
    b_e = torch.einsum("qn,eqv->env", ops.B, fq * gf.wdetJ[..., None])
    return _scatter_components(b_e, dof_slots(ops.eldofs, ops.fes.nscalar))


def vector_boundary_lf(ops: SpaceOps, g, attr_marker=None, vdim=None,
                       time=None, vertices=None):
    """(g, v) over marked boundary faces with a vector traction g."""
    f = ops.face
    vdim = vdim or ops.G.shape[-1]
    n = ops.fes.nscalar
    if f is None:
        return torch.zeros(n * vdim, dtype=ops.dtype, device=ops.device)
    ff = ops.face_factors(vertices)
    flat = ff.xq.reshape(-1, ff.xq.shape[-1])
    gq = _vector_values(g, flat, time, vdim, tuple(ff.xq.shape[:-1]))
    if attr_marker is not None:
        mask = np.isin(f["attr"], np.asarray(list(attr_marker)))
        gq = gq * torch.as_tensor(mask, dtype=gq.dtype,
                                  device=gq.device)[:, None, None]
    b_f = torch.einsum("qn,fqv->fnv", f["B"], gq * ff.wdS[..., None])
    return _scatter_components(b_f, dof_slots(f["dofs"], n))
