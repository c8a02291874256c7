"""Element-sharded ablation (T, p) Newton step over the ranks of a world.

Port of ``cmfem_tpu/parallel/ablation_sharded.py`` on ``torch.distributed``:
the flagship coupled pyrolysis solve split the way the reference's ablation
drivers split it under ``mpirun -np N``.  Each rank owns a contiguous slab
of elements (with their per-QP reaction state and geometric factors); the
T/p DOF vectors are replicated:

- **residual**: the per-element quadrature work of
  ``AblationSystem.elem_residual_fn`` under ``torch.func.vmap`` on the local
  slab, a local scatter and one ``all_reduce``;
- **Jacobian**: ``vmap(jacfwd)`` of that closure on the slab, with no
  communication;
- **linear solve**: the equilibrated point-block GMRES of
  ``solvers.blocksolve`` with the matvec distributed the same way (local
  batched (2nd, 2nd) block matvec, local scatter, one ``all_reduce``); the
  equilibration and the preconditioner reduce their diagonals with one
  ``all_reduce`` each;
- **SEB top boundary** (cases 2.1/2.2): each boundary face goes to the rank
  owning its adjacent element, so the face residual and its AD blocks are
  folded into the local element blocks with no extra communication
  (``seb=(branch, model, bprime)``; the aerothermal ``BoundaryState`` is a
  call argument).

Element padding (to a multiple of the rank count) repeats element 0's DOF
map with zero quadrature weights, so padded elements contribute exactly
zero; pad faces carry zero face weights.

Every local scatter sums each DOF's contributions in a fixed order
(``ops.assembly.fixed_order_scatter``), never with ``index_add_``, whose
atomics on the card add in an order that changes from run to run: every
rank then holds the same bits of every replicated vector, and their GMRES
loops take the same exits.  ``seb_face_res_fn`` of the port binds the
boundary state in its closure, where the JAX package passes it through
``vmap`` with ``in_axes=None``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assembly import dof_slots, fixed_order_scatter
from ..physics.ablation import AblationSystem
from ..solvers.blocksolve import (equilibrated_block_factors,
                                  solve_equilibrated)
from .sharding import DeviceMesh


def fold_face_blocks(Je, Fe, face_slots, nd):
    """Add the SEB face blocks Fe (nf, nd, 2nd) to the T rows of their
    elements' blocks Je (ne, 2nd, 2nd), summed in a fixed order
    (``face_slots``: ``dof_slots`` of the faces' local element ids)."""
    rows = torch.cat([Fe.reshape(Fe.shape[0], -1),
                      Fe.new_zeros((1, Fe[0].numel()))])
    add = rows[face_slots].sum(dim=1).reshape(Je.shape[0], nd, -1)
    return torch.cat([Je[:, :nd, :] + add, Je[:, nd:, :]], dim=1)


def element_blocks(elem_res, T_e, p_e, *args):
    """(ne, 2nd, 2nd) element Jacobian blocks d(rT, rp)/d(T_e, p_e) of
    ``elem_res`` by ``vmap(jacfwd)``."""
    jac = torch.func.vmap(torch.func.jacfwd(elem_res, argnums=(0, 1)))
    (JTT, JTp), (JpT, Jpp) = jac(T_e, p_e, *args)
    return torch.cat([torch.cat([JTT, JTp], dim=2),
                      torch.cat([JpT, Jpp], dim=2)], dim=1)


def face_blocks(face_res, T_f, p_f, *args):
    """(nf, nd, 2nd) SEB face blocks d(rT_face)/d(T_e, p_e)."""
    jacf = torch.func.vmap(torch.func.jacfwd(face_res, argnums=(0, 1)))
    FJT, FJp = jacf(T_f, p_f, *args)
    return torch.cat([FJT, FJp], dim=2)


def ale_slabs(wq, gcl, nel, nq, dim, like):
    """Local ALE mesh-velocity and GCL-Jacobian slabs: zeros and the
    disabled sentinel -1 when the caller gives none."""
    if wq is None:
        wq = like.new_zeros((nel, nq, dim))
    if gcl is None:
        Jo = Jn = like.new_full((nel, nq), -1.0)
    else:
        Jo, Jn = gcl
    return wq, Jo, Jn


class ShardedAblationNewton:
    """Element-sharded residual / AD Jacobian / block GMRES for the coupled
    (T, p) ablation system over the ranks of ``mesh``
    (``parallel.make_device_mesh``).  The system must live on the mesh's
    device; every rank builds it whole and keeps its own slab here."""

    def __init__(self, system: AblationSystem, mesh: DeviceMesh, ess_T,
                 ess_p, restart: int = 400, maxiter: int = 10, seb=None,
                 ale_toggles=(True, True, True)):
        self.sys = system
        self.mesh = mesh
        self.ale_toggles = tuple(ale_toggles)
        self.n = system.n
        ops = system.ops
        self.nd = int(ops.eldofs.shape[1])
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self.seb = seb
        dev = mesh.device
        self.device = dev

        ndev, r = mesh.size, mesh.rank
        ne = system.ne
        self.ne = ne
        self.ne_pad = ((ne + ndev - 1) // ndev) * ndev
        self._pad = self.ne_pad - ne
        epd = self.ne_pad // ndev
        self._lo, self._hi = r * epd, (r + 1) * epd

        mask = np.zeros(2 * self.n, dtype=bool)
        mask[np.asarray(ess_T, dtype=np.int64)] = True
        mask[np.asarray(ess_p, dtype=np.int64) + self.n] = True
        self.mask2 = torch.as_tensor(mask, device=dev)

        eldofs = np.asarray(ops.fes.element_dofs, dtype=np.int64)
        if self._pad:
            eldofs = np.concatenate(
                [eldofs, np.repeat(eldofs[:1], self._pad, axis=0)])
        eldofs = eldofs[self._lo:self._hi]
        self.eldofs = torch.as_tensor(eldofs, device=dev)
        self.slots = dof_slots(self.eldofs, self.n)
        self.invJ = self.pad_elem(ops.gf.invJ)
        self.wdetJ = self._pad_zero(ops.gf.wdetJ)
        # local essential masks over the padded element slab
        self.lmask = torch.as_tensor(
            np.concatenate([mask[:self.n][eldofs], mask[self.n:][eldofs]],
                           axis=1), device=dev)

        if seb is not None:
            # each top-boundary face goes to the rank owning its adjacent
            # element; every rank pads to the same face count with
            # zero-weight copies of face 0
            tr = system.trace
            elem = np.asarray(tr.elem, dtype=np.int64)
            if len(elem) == 0:
                raise ValueError(
                    "SEB enabled but the top-boundary trace selects no "
                    "faces — check the boundary attribute")
            owner = elem // epd
            self.nf_local = max(1, int(np.bincount(owner,
                                                   minlength=ndev).max()))
            mine = np.nonzero(owner == r)[0]
            self._faces = torch.as_tensor(mine, device=dev)
            self._nf_mine = len(mine)
            ff = tr.face_factors()
            self._f = {
                "Bf": self._pack_faces(tr.Btab[tr._combo_t]),
                "Gf": self._pack_faces(tr.Gtab[tr._combo_t]),
                "invJf": self._pack_faces(tr.element_invJ()),
                "nrm": self._pack_faces(ff.normal),
                "wdS": self._pack_faces(ff.wdS, zero_fill=True),
                "eldofs_f": self._pack_faces(tr.eldofs),
                "elem_local": self._pack_faces(
                    torch.as_tensor(elem - owner * epd, device=dev),
                    zero_fill=True),
            }
            self.fslots = dof_slots(self._f["eldofs_f"], self.n)
            self.face_slots = dof_slots(self._f["elem_local"][:, None], epd)

    # -- helpers -------------------------------------------------------------

    def _slab(self, a, fill):
        a = torch.as_tensor(a, device=self.device)
        if self._pad:
            pad = a[:1].expand((self._pad,) + a.shape[1:]) if fill == "dup" \
                else a.new_zeros((self._pad,) + a.shape[1:])
            a = torch.cat([a, pad])
        return a[self._lo:self._hi].contiguous()

    def pad_elem(self, a):
        """This rank's slab of an (ne, ...) per-element array (a tensor or
        numpy), padded by copies of element 0, on the mesh's device."""
        return self._slab(a, "dup")

    def _pad_zero(self, a):
        """As ``pad_elem`` with zero pad rows (quadrature weights: they null
        every padded-element contribution, dtype preserved)."""
        return self._slab(a, "zero")

    def _pack_faces(self, a, zero_fill=False):
        """This rank's (nf_local, ...) face slab of a per-face tensor:
        its own faces, then pad slots holding face 0's data (finite, never
        read with weight) or zeros (``zero_fill``: face weights and local
        element ids)."""
        a = a.to(self.device)
        shape = (self.nf_local,) + a.shape[1:]
        out = a.new_zeros(shape) if zero_fill \
            else a[:1].expand(shape).clone()
        out[:self._nf_mine] = a[self._faces]
        return out

    def update_geometry(self, vertices):
        """Refresh the slab's geometric factors (and the SEB face geometry)
        for moved mesh vertices: the case-2.2 ALE step."""
        gf = self.sys.ops.geometric_factors(vertices)
        self.invJ = self.pad_elem(gf.invJ)
        self.wdetJ = self._pad_zero(gf.wdetJ)
        if self.seb is not None:
            tr = self.sys.trace
            ff = tr.face_factors(vertices)
            self._f["invJf"] = self._pack_faces(tr.element_invJ(vertices))
            self._f["nrm"] = self._pack_faces(ff.normal)
            self._f["wdS"] = self._pack_faces(ff.wdS, zero_fill=True)

    def _gather_local(self, x):
        return torch.cat([x[:self.n][self.eldofs], x[self.n:][self.eldofs]],
                         dim=1)

    def _scatter_local(self, y_e):
        nd = self.nd
        return torch.cat([fixed_order_scatter(y_e[:, :nd], self.slots),
                          fixed_order_scatter(y_e[:, nd:], self.slots)])

    def _face_args(self, T, p, Xo):
        """(T_f, p_f, B, G, invJ, normal, wdS, X) of this rank's faces."""
        f = self._f
        ed = f["eldofs_f"]
        return (T[ed], p[ed], f["Bf"], f["Gf"], f["invJf"], f["nrm"],
                f["wdS"], Xo[f["elem_local"], 0])

    def _face_res(self, bc):
        return self.sys.seb_face_res_fn(bc, *self.seb)

    def _elem_args(self, T, p, To, po, Xo, wq, gcl):
        wqe, Jo, Jn = ale_slabs(wq, gcl, self.eldofs.shape[0],
                                self.wdetJ.shape[1], self.invJ.shape[-1],
                                self.wdetJ)
        return (T[self.eldofs], p[self.eldofs], self.invJ, self.wdetJ, To,
                po, Xo, wqe, Jo, Jn)

    # -- residual -------------------------------------------------------------

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, bc=None, wq=None,
                 gcl=None):
        """BC-masked global residual (2n,), the same on every rank.  The
        per-element state arrays are this rank's slabs (``pad_elem``);
        ``bc`` is the aerothermal BoundaryState (SEB instances only);
        ``wq`` ((ne, nq, dim) mesh velocity at the QPs) and ``gcl``
        ((J_old, J_new) per-QP Jacobian pairs) enable the case-2.2 ALE
        advective and geometric-conservation terms (slabs too)."""
        elem_res = self.sys.elem_residual_fn(
            dt, gcl_enabled=gcl is not None, ale_toggles=self.ale_toggles)
        rT_e, rp_e = torch.func.vmap(elem_res)(
            *self._elem_args(T, p, T_old_q, p_old_q, X_old, wq, gcl))
        yT = fixed_order_scatter(rT_e, self.slots)
        if self.seb is not None:
            rTf = torch.func.vmap(self._face_res(bc))(
                *self._face_args(T, p, X_old))
            yT = yT + fixed_order_scatter(rTf, self.fslots)
        y = torch.cat([yT, fixed_order_scatter(rp_e, self.slots)])
        return torch.where(self.mask2, 0.0, self.mesh.all_reduce(y))

    # -- Jacobian preparation --------------------------------------------------

    def prepare(self, T, p, T_old_q, p_old_q, X_old, dt, bc=None, wq=None,
                gcl=None):
        """AD-assemble, BC-eliminate and equilibrate the slab's element
        blocks; returns (Je_s (this rank's slab), pb, s), pb and s the same
        on every rank."""
        elem_res = self.sys.elem_residual_fn(
            dt, gcl_enabled=gcl is not None, ale_toggles=self.ale_toggles)
        Je = element_blocks(elem_res, *self._elem_args(
            T, p, T_old_q, p_old_q, X_old, wq, gcl))
        if self.seb is not None:
            Fe = face_blocks(self._face_res(bc),
                             *self._face_args(T, p, X_old))
            Je = fold_face_blocks(Je, Fe, self.face_slots, self.nd)
        return equilibrated_block_factors(
            Je, self.lmask, self.mask2, self._gather_local,
            self._scatter_local, self.nd, self.n,
            reduce_fn=self.mesh.all_reduce)

    # -- linear solve -----------------------------------------------------------

    def matvec(self, Je_s, y):
        """The distributed equilibrated matvec of replicated ``y``."""
        y_e = torch.einsum("eij,ej->ei", Je_s, self._gather_local(y))
        return self.mesh.all_reduce(self._scatter_local(y_e))

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        """Distributed GMRES solve of J dx = b (factors from ``prepare``);
        every rank runs it on the replicated vectors."""
        Je_s, pb, s = factors
        return solve_equilibrated(lambda y: self.matvec(Je_s, y), pb, s, b,
                                  self.mask2, self.n, float(rtol),
                                  float(atol), self.restart, self.maxiter)

    # -- one full Newton iterate ------------------------------------------------

    def newton_step(self, T, p, T_old_q, p_old_q, X_old, dt, rtol=1e-10,
                    bc=None, wq=None, gcl=None):
        """One distributed Newton iterate: residual -> AD Jacobian ->
        equilibrated block GMRES -> update.  Returns (T', p', |R|, GMRES
        restart cycles).  Essential DOFs are held fixed (the caller pre-sets
        their values)."""
        R = self.residual(T, p, T_old_q, p_old_q, X_old, dt, bc=bc, wq=wq,
                          gcl=gcl)
        fac = self.prepare(T, p, T_old_q, p_old_q, X_old, dt, bc=bc, wq=wq,
                           gcl=gcl)
        res = self.solve(fac, -R, rtol=rtol)
        dx, n = res.x, self.n
        return (T + dx[:n], p + dx[n:], torch.linalg.vector_norm(R),
                res.iters)
