"""Assembly into quadrature-point operator data + matrix-free apply.

Port of ``cmfem_tpu/ops/assembly.py`` (MFEM's ``BilinearForm`` with
``MassIntegrator``/``DiffusionIntegrator``/``ConvectionIntegrator``).
Every bilinear form reduces to quadrature-point data acting on the
value/reference-gradient pair of the trial function:

    y_e = B^T [ d00 * u_q + d01 . (grad_ref u)_q ]
        + G^T [ d10 * u_q + d11 (grad_ref u)_q ]

with the geometric factors folded in.  ``jax.ops.segment_sum`` becomes
``index_add_``.  SUPG, matrix diffusion, element matrices, linear forms and
error norms come in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.fespace import FESpace
from ..core.geometry import GeometricFactors, compute_geometric_factors_host
from ..core.quadrature import gauss_rule
from ..core.reference_elements import get_reference_element


def eval_coefficient(coeff, xq, time=None):
    """Evaluate a scalar coefficient at physical QPs xq (..., dim).

    coeff: float | tensor broadcastable to xq[...,0] | callable(x[, t])."""
    if callable(coeff):
        flat = xq.reshape(-1, xq.shape[-1])
        vals = coeff(flat) if time is None else coeff(flat, time)
        return torch.as_tensor(vals, dtype=xq.dtype,
                               device=xq.device).reshape(xq.shape[:-1])
    c = torch.as_tensor(coeff, dtype=xq.dtype, device=xq.device)
    return torch.broadcast_to(c, xq.shape[:-1])


def _eval_vector(coeff, xq, time=None):
    """Vector coefficient -> (ne, nq, dim)."""
    if callable(coeff):
        flat = xq.reshape(-1, xq.shape[-1])
        vals = coeff(flat) if time is None else coeff(flat, time)
        return torch.as_tensor(vals, dtype=xq.dtype,
                               device=xq.device).reshape(xq.shape)
    c = torch.as_tensor(np.asarray(coeff), dtype=xq.dtype, device=xq.device)
    return torch.broadcast_to(c, xq.shape)


class SpaceOps:
    """Per-(space, quadrature) tabulations + geometric factors as tensors
    on ``device`` in ``dtype``.  The factors are computed on the host in
    float64 (``compute_geometric_factors_host``) and then moved."""

    def __init__(self, fes: FESpace, quad_order: int | None = None, *,
                 device, dtype=torch.float64):
        self.fes = fes
        self.device = torch.device(device)
        self.dtype = dtype
        mesh = fes.mesh
        if quad_order is None:
            quad_order = 2 * fes.order + 1
        self.quad = gauss_rule(mesh.geom, quad_order)
        B, G = fes.ref.eval(self.quad.points)
        self.B = torch.as_tensor(B, dtype=dtype, device=self.device)
        self.G = torch.as_tensor(G, dtype=dtype, device=self.device)
        self.eldofs = torch.as_tensor(fes.element_dofs.astype(np.int64),
                                      device=self.device)
        Bgeo, Ggeo = get_reference_element(mesh.geom, 1).eval(
            self.quad.points)
        self.gf = compute_geometric_factors_host(
            np.asarray(mesh.vertices)[np.asarray(mesh.elem_conn)],
            Bgeo, Ggeo, self.quad.weights,
        ).to(self.device, dtype)

    def scatter(self, y_e):
        """(ne, ndof) element contributions -> global (n,) by index_add_."""
        out = torch.zeros(self.fes.nscalar, dtype=y_e.dtype,
                          device=y_e.device)
        return out.index_add_(0, self.eldofs.reshape(-1), y_e.reshape(-1))


@dataclass
class OperatorData:
    """Quadrature-level operator blocks (geometric factors folded in)."""

    d00: torch.Tensor | None = None  # (ne, nq)
    d01: torch.Tensor | None = None  # (ne, nq, dim) acting on ref-grad
    d10: torch.Tensor | None = None  # (ne, nq, dim)
    d11: torch.Tensor | None = None  # (ne, nq, dim, dim) ref-grad -> ref-grad

    def __add__(self, o: "OperatorData") -> "OperatorData":
        def s(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return a + b

        return OperatorData(s(self.d00, o.d00), s(self.d01, o.d01),
                            s(self.d10, o.d10), s(self.d11, o.d11))


class BilinearForm:
    """A sum of domain integrators over one scalar H1 space.

    Usage:
        a = BilinearForm(ops).add_mass(c).add_diffusion(k).add_convection(b)
        data = a.assemble()          # OperatorData
        y = a.apply(data, u)         # matrix-free A @ u
        diag = a.assemble_diagonal(data)
    """

    def __init__(self, ops: SpaceOps):
        self.ops = ops
        self._parts = []  # list of callables gf -> OperatorData

    def add_mass(self, coeff=1.0, time=None):
        """(c u, v) — MassIntegrator."""

        def build(gf: GeometricFactors):
            c = eval_coefficient(coeff, gf.xq, time)
            return OperatorData(d00=c * gf.wdetJ)

        self._parts.append(build)
        return self

    def add_diffusion(self, coeff=1.0, time=None):
        """(c grad u, grad v) — DiffusionIntegrator."""

        def build(gf: GeometricFactors):
            c = eval_coefficient(coeff, gf.xq, time)
            # K[r,s] = c wdetJ sum_d invJ[r,d] invJ[s,d]
            K = torch.sum(gf.invJ[:, :, :, None, :]
                          * gf.invJ[:, :, None, :, :], dim=-1)
            return OperatorData(d11=K * (c * gf.wdetJ)[..., None, None])

        self._parts.append(build)
        return self

    def add_convection(self, beta, alpha=1.0, time=None):
        """alpha (beta . grad u, v) — ConvectionIntegrator."""

        def build(gf: GeometricFactors):
            b = _eval_vector(beta, gf.xq, time)  # (ne, nq, dim)
            # d01[r] = alpha wdetJ sum_d beta_d invJ[r,d]
            d01 = torch.sum(b[..., None, :] * gf.invJ, dim=-1)
            return OperatorData(d01=alpha * d01 * gf.wdetJ[..., None])

        self._parts.append(build)
        return self

    def assemble(self, gf: GeometricFactors | None = None) -> OperatorData:
        gf = gf or self.ops.gf
        out = OperatorData()
        for p in self._parts:
            out = out + p(gf)
        return out

    def apply(self, data: OperatorData, u):
        """Matrix-free y = A u (partial assembly apply)."""
        ops = self.ops
        u_e = u[ops.eldofs]  # (ne, ndof)
        uq = torch.einsum("qn,en->eq", ops.B, u_e)
        gq = torch.einsum("qnr,en->eqr", ops.G, u_e)
        bq = torch.zeros_like(uq)
        if data.d00 is not None:
            bq = bq + data.d00 * uq
        if data.d01 is not None:
            bq = bq + torch.sum(data.d01 * gq, dim=-1)
        fq = None
        if data.d10 is not None:
            fq = data.d10 * uq[..., None]
        if data.d11 is not None:
            t = torch.sum(data.d11 * gq[..., None, :], dim=-1)
            fq = t if fq is None else fq + t
        y_e = torch.einsum("qn,eq->en", ops.B, bq)
        if fq is not None:
            y_e = y_e + torch.einsum("qnr,eqr->en", ops.G, fq)
        return ops.scatter(y_e)

    def assemble_diagonal(self, data: OperatorData):
        """Global diagonal of A (for Jacobi preconditioning)."""
        ops = self.ops
        B, G = ops.B, ops.G
        d = torch.zeros((ops.eldofs.shape[0], B.shape[1]), dtype=B.dtype,
                        device=B.device)
        if data.d00 is not None:
            d = d + torch.einsum("qi,eq,qi->ei", B, data.d00, B)
        if data.d01 is not None:
            d = d + torch.einsum("qi,eqr,qir->ei", B, data.d01, G)
        if data.d10 is not None:
            d = d + torch.einsum("qir,eqr,qi->ei", G, data.d10, B)
        if data.d11 is not None:
            d = d + torch.einsum("qir,eqrs,qis->ei", G, data.d11, G)
        return ops.scatter(d)
