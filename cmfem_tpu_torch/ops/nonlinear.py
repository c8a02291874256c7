"""Nonlinear forms: QP-level residual functions + AD Jacobians.

Port of ``cmfem_tpu/ops/nonlinear.py`` (MFEM ``NonlinearForm`` with custom
integrators, e.g. nonlinear_convection_diffusion_1D.cpp:418-642): the user
writes only the QP residual density, and the Jacobian comes from forward-mode
AD of the whole form, ``torch.func`` in place of ``jax``:

    jax.jvp                   -> torch.func.jvp
    jax.linearize             -> torch.func.linearize
    jax.vmap(jax.jacfwd(...)) -> torch.func.vmap(torch.func.jacfwd(...))
    A.at[rows, cols].add      -> index_put_(..., accumulate=True)

The QP residual signature:

    qp_residual(uq, gradq, xq, **aux) -> (r0, r1)

where uq (ne,nq) values, gradq (ne,nq,dim) physical gradients, xq physical
positions; r0 multiplies the test function, r1 its physical gradient:

    R_i = sum_q w detJ [ psi_i r0 + grad(psi_i) . r1 ].

``element_jacobians`` runs ``qp_residual`` under ``vmap``: it must be written
with torch operations and must not branch on tensor values (no ``.item()``,
no Python ``if`` on data).
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch.func import jacfwd, jvp, linearize, vmap

from .assembly import SpaceOps
from ..core.geometry import GeometricFactors


class NonlinearForm:
    def __init__(self, ops: SpaceOps, qp_residual: Callable):
        self.ops = ops
        self.qp_residual = qp_residual
        # values and reference gradients of the basis side by side, (nd,
        # nq (1 + dim)): one product gives both at every QP, one product
        # takes both weights back (few launches: the residual and its JVP
        # run once per Krylov iteration, where host time per op decides)
        self._W = torch.cat([ops.B[..., None], ops.G], dim=-1) \
            .permute(1, 0, 2).reshape(ops.B.shape[1], -1)

    def residual(self, u, gf: GeometricFactors | None = None, **aux):
        ops = self.ops
        gf = gf or ops.gf
        ne, nq, dim = gf.xq.shape
        vg = (u[ops.eldofs] @ self._W).view(ne, nq, 1 + dim)
        uq, gref = vg[..., 0], vg[..., 1:]
        gq = torch.sum(gf.invJ * gref[..., :, None], dim=-2)
        r0, r1 = self.qp_residual(uq, gq, gf.xq, **aux)
        r0 = torch.zeros_like(uq) if r0 is None else r0
        # pull physical gradient weight back to reference: G^T (invJ r1)
        r1ref = torch.zeros_like(gref) if r1 is None \
            else torch.sum(gf.invJ * r1[..., None, :], dim=-1)
        w = torch.cat([r0[..., None], r1ref], dim=-1) * gf.wdetJ[..., None]
        return ops.scatter(w.view(ne, -1) @ self._W.T)

    def jvp(self, u, v, gf: GeometricFactors | None = None, **aux):
        """Jacobian-vector product J(u) v by forward-mode AD (the residual
        is recomputed with each product)."""
        f = lambda x: self.residual(x, gf=gf, **aux)
        _, jv = jvp(f, (u,), (v,))
        return jv

    def linearize(self, u, gf: GeometricFactors | None = None, **aux):
        """Returns (R(u), v -> J(u) v) with shared linearization work
        (``torch.func.linearize`` traces the JVP once per point)."""
        f = lambda x: self.residual(x, gf=gf, **aux)
        with warnings.catch_warnings():
            # const_fold's note on each folded constant of the trace
            warnings.filterwarnings("ignore", message=".*get_attr Node.*")
            return linearize(f, u)

    def element_jacobians(self, u, gf: GeometricFactors | None = None, **aux):
        """(ne, ndof, ndof) element Jacobian blocks by vmapped jacfwd.

        Exact only when the QP residual is local in u (true for all the
        reference's integrators)."""
        ops = self.ops
        gf = gf or ops.gf
        ne = gf.wdetJ.shape[0]
        # aux tensors with a leading element axis are sliced per element;
        # everything else is broadcast unchanged
        mapped_keys = [k for k, v in aux.items()
                       if torch.is_tensor(v) and v.ndim >= 1
                       and v.shape[0] == ne]
        static_aux = {k: v for k, v in aux.items() if k not in mapped_keys}
        B, G, qp_residual = ops.B, ops.G, self.qp_residual

        def elem_res(u_e, invJ, wdetJ, xq, mapped_vals):
            el_aux = dict(static_aux)
            for k, v in zip(mapped_keys, mapped_vals):
                el_aux[k] = v[None]
            uq = torch.einsum("qn,n->q", B, u_e)[None]
            gref = torch.einsum("qnr,n->qr", G, u_e)
            gq = torch.sum(invJ * gref[..., :, None], dim=-2)[None]
            r0, r1 = qp_residual(uq, gq, xq[None], **el_aux)
            y = torch.zeros_like(u_e)
            if r0 is not None:
                y = y + torch.einsum("qn,q->n", B, r0[0] * wdetJ)
            if r1 is not None:
                r1ref = torch.sum(invJ * r1[0][..., None, :], dim=-1)
                y = y + torch.einsum("qnr,qr->n", G, r1ref * wdetJ[:, None])
            return y

        u_e = u[ops.eldofs]
        mapped_vals = [aux[k] for k in mapped_keys]
        jac = vmap(jacfwd(elem_res), in_dims=(0, 0, 0, 0, 0))
        return jac(u_e, gf.invJ, gf.wdetJ, gf.xq, mapped_vals)

    def jacobian_diagonal(self, u, gf: GeometricFactors | None = None, **aux):
        """Global diagonal of J(u) (for Jacobi-preconditioned Krylov)."""
        Je = self.element_jacobians(u, gf=gf, **aux)
        return self.ops.scatter(torch.diagonal(Je, dim1=1, dim2=2))

    def dense_jacobian(self, u, gf: GeometricFactors | None = None, **aux):
        """Dense global Jacobian (small/debug problems)."""
        ops = self.ops
        Je = self.element_jacobians(u, gf=gf, **aux)
        n, nd = ops.fes.nscalar, Je.shape[1]
        rows = ops.eldofs[:, :, None].expand(-1, nd, nd)
        cols = ops.eldofs[:, None, :].expand(-1, nd, nd)
        A = torch.zeros((n, n), dtype=Je.dtype, device=Je.device)
        return A.index_put_((rows.reshape(-1), cols.reshape(-1)),
                            Je.reshape(-1), accumulate=True)
