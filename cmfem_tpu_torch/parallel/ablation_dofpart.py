"""DOF-partitioned ablation (T, p) Newton step: memory per rank ∝ 1/N.

Port of ``cmfem_tpu/parallel/ablation_dofpart.py`` on ``torch.distributed``.
``parallel.ablation_sharded`` splits the work of the flagship coupled
solve (element quadrature, AD Jacobians, GMRES matvecs) but keeps the
(T, p) DOF vectors whole on every rank.  Here each rank stores only its
owned slab of both fields (plus ghost copies of the partition-interface
DOFs its elements touch), as the reference's ablation drivers do on a
``ParFiniteElementSpace`` under ``mpirun -np N``.

Layout: a distributed two-field vector is this rank's (2 * nown_max,)
slab [T_own | p_own], zero above its owned counts (the JAX package holds
the (ndev * 2 * nown_max,) array of all the slabs, sharded).  Every halo
exchange moves both fields in one interface ``all_reduce`` of a (2, nif)
stack; an operator apply costs two such exchanges (forward values, reverse
ghost contributions), and the equilibration and preconditioner build
assembles its diagonals with ``halo_assemble``.  The GMRES is
``solvers.krylov.gmres`` with ``reduce=mesh.all_reduce``: each
Gram-Schmidt pass and each norm is one ``all_reduce`` of local partial
sums (under GSPMD the JAX package's dots are global reductions by
construction).  Pads stay exactly zero.

SEB surface physics (cases 2.1/2.2): each top-boundary face rides the
rank owning its adjacent element, whose DOFs lie in that rank's [owned |
ghost] space by construction, so the face residual and its AD blocks add
no communication.  Local scatters sum in a fixed order
(``ops.assembly.fixed_order_scatter``).

``to_dist2(T, p, rank)`` takes rank ``rank``'s slab of global fields and
``from_dist2`` rebuilds them from the stacked slabs of every rank
(``mesh.all_gather`` of the slabs), as ``DofPartition.to_dist``/
``from_dist`` do (a deviation: the JAX package converts the whole sharded
array at once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assembly import dof_slots, fixed_order_scatter
from ..physics.ablation import AblationSystem
from ..solvers.blocksolve import equilibrated_block_factors
from ..solvers.krylov import gmres
from .ablation_sharded import element_blocks, face_blocks, fold_face_blocks
from .dofpart import DofPartition, halo_assemble, halo_forward, halo_reverse
from .sharding import DeviceMesh


class DofPartitionedAblationNewton:
    """Distributed residual / AD Jacobian / block GMRES for the coupled
    (T, p) ablation system with DOF-partitioned vectors.

    Covers the static-mesh solves (cases 1 and 2.1) and the moving mesh
    (case 2.2): ``update_geometry`` refreshes the packed geometric factors
    after each mesh move, and ``residual``/``prepare`` take per-step ALE
    mesh-velocity slabs (``wq``) and GCL J_old/J_new slabs (``gcl``) packed
    with ``pack_elem``."""

    def __init__(self, system: AblationSystem, mesh: DeviceMesh, ess_T,
                 ess_p, restart: int = 400, maxiter: int = 10, seb=None,
                 parts=None, ale_toggles=(True, True, True),
                 gcl_enabled=False):
        self.sys = system
        self.mesh = mesh
        self.n = system.n
        ops = system.ops
        self.nd = int(ops.eldofs.shape[1])
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self.seb = seb
        self.ale_toggles = tuple(ale_toggles)
        self.gcl_enabled = bool(gcl_enabled)
        self.ndev = ndev = mesh.size
        r, dev = mesh.rank, mesh.device
        self.device = dev

        dp = DofPartition(np.asarray(ops.fes.element_dofs, dtype=np.int64),
                          self.n, ndev, parts=parts, mesh=ops.fes.mesh)
        self.part = dp
        self.nown_max = dp.nown_max
        self.n_loc = dp.n_loc
        idx = lambda a: torch.as_tensor(a[r], device=dev)

        self.eldofs_loc = idx(dp.eldofs_loc_np)
        self.slots = dof_slots(self.eldofs_loc, dp.n_loc)
        self.invJ = self.pack_elem(ops.gf.invJ, "dup")
        # zero quadrature weights null every padded-element contribution
        self.wdetJ = self.pack_elem(ops.gf.wdetJ, "zero")
        self.pub_src = idx(dp.pub_src_np)
        self.pub_dst = idx(dp.pub_dst_np)
        self.pub_src_rev = idx(dp.pub_src_rev_np)
        self.ghost_src = idx(dp.ghost_src_np)
        # global DOF of every slab slot, rank by rank (from_dist2)
        self._owned = [torch.as_tensor(o, device=dev) for o in dp.owned]

        # -- essential / padding masks -------------------------------------
        maskT = np.zeros(self.n, dtype=bool)
        maskT[np.asarray(ess_T, dtype=np.int64)] = True
        maskp = np.zeros(self.n, dtype=bool)
        maskp[np.asarray(ess_p, dtype=np.int64)] = True

        def local_mask(m):
            out = np.ones(dp.n_loc, dtype=bool)       # pads masked
            out[:len(dp.owned[r])] = m[dp.owned[r]]
            out[dp.nown_max:dp.nown_max + len(dp.ghosts[r])] = \
                m[dp.ghosts[r]]
            return out

        mT_loc, mp_loc = local_mask(maskT), local_mask(maskp)
        self.mask2_loc = torch.as_tensor(np.concatenate([mT_loc, mp_loc]),
                                         device=dev)
        own = slice(0, dp.nown_max)
        self.mask_own2 = torch.as_tensor(
            np.concatenate([mT_loc[own], mp_loc[own]]), device=dev)
        # element-local essential masks; pad rows all zero so padded
        # elements add no identity diagonals to the equilibration
        ed = np.asarray(ops.fes.element_dofs, dtype=np.int64)
        self.lmask = self.pack_elem(
            np.concatenate([maskT[ed], maskp[ed]], axis=1), "zero")

        # -- SEB faces on the rank of their adjacent element ----------------
        if seb is not None:
            tr = system.trace
            elem = np.asarray(tr.elem, dtype=np.int64)
            if len(elem) == 0:
                raise ValueError(
                    "SEB enabled but the top-boundary trace selects no "
                    "faces — check the boundary attribute")
            fowner = dp.parts[elem]
            self.nf_local = max(1, int(np.bincount(fowner,
                                                   minlength=ndev).max()))
            mine = np.nonzero(fowner == r)[0]
            self._faces = torch.as_tensor(mine, device=dev)
            self._nf_mine = len(mine)
            # position of each element within its rank's packed batch
            epos = np.full(system.ne, -1, dtype=np.int64)
            epos[dp.elem_idx[r]] = np.arange(len(dp.elem_idx[r]))
            fed = tr.eldofs.cpu().numpy()
            eldofs_f_loc = dp.loc_maps[r][fed[mine]]
            if (eldofs_f_loc < 0).any():
                raise RuntimeError("a face DOF is missing from its rank's "
                                   "local space")
            ff = tr.face_factors()
            self._f = {
                "Bf": self._pack_face("Bf", tr.Btab[tr._combo_t]),
                "Gf": self._pack_face("Gf", tr.Gtab[tr._combo_t]),
                "invJf": self._pack_face("invJf", tr.element_invJ()),
                "nrm": self._pack_face("nrm", ff.normal),
                "wdS": self._pack_face("wdS", ff.wdS),
                "eldofs_f": self._pack_mine(eldofs_f_loc),
                "elem_local": self._pack_mine(epos[elem[mine]]),
            }
            self.fslots = dof_slots(self._f["eldofs_f"], dp.n_loc)
            self.face_slots = dof_slots(self._f["elem_local"][:, None],
                                        dp.ne_max)

        self._wq0 = None
        self._J0 = None

    # -- packing ----------------------------------------------------------------

    def _pack_face(self, k, a):
        """This rank's (nf_local, ...) slab of a per-face tensor: its own
        faces, then pad slots of face 0's data (zeros for the face
        weights)."""
        a = a.to(self.device)
        shape = (self.nf_local,) + a.shape[1:]
        out = a.new_zeros(shape) if k == "wdS" \
            else a[:1].expand(shape).clone()
        out[:self._nf_mine] = a[self._faces]
        return out

    def _pack_mine(self, a):
        """Zero-padded (nf_local, ...) slab of per-face rows that are this
        rank's already (local DOF maps and element positions)."""
        a = np.asarray(a, dtype=np.int64)
        out = np.zeros((self.nf_local,) + a.shape[1:], dtype=np.int64)
        out[:len(a)] = a
        return torch.as_tensor(out, device=self.device)

    def pack_elem(self, a, fill="dup"):
        """This rank's (ne_max, ...) packed batch of an (ne, ...) per-element
        array (tensor or numpy) on the mesh's device: pad rows repeat the
        rank's first element (``"dup"``) or are zero (``"zero"``)."""
        dp, r = self.part, self.mesh.rank
        a = torch.as_tensor(a, device=self.device)
        idx = dp.elem_idx[r]
        out = a.new_zeros((dp.ne_max,) + a.shape[1:])
        out[:len(idx)] = a[torch.as_tensor(idx, device=self.device)]
        if fill == "dup":
            out[len(idx):] = a[int(idx[0]) if len(idx) else 0]
        return out

    def update_geometry(self, vertices):
        """Refresh the packed geometric factors (and the SEB face geometry)
        for moved mesh vertices: the case-2.2 ALE step."""
        gf = self.sys.ops.geometric_factors(vertices)
        self.invJ = self.pack_elem(gf.invJ, "dup")
        self.wdetJ = self.pack_elem(gf.wdetJ, "zero")
        if self.seb is not None:
            tr = self.sys.trace
            ff = tr.face_factors(vertices)
            for k, a in (("invJf", tr.element_invJ(vertices)),
                         ("nrm", ff.normal), ("wdS", ff.wdS)):
                self._f[k] = self._pack_face(k, a)

    def _ale_defaults(self, wq, gcl):
        """Packed zero mesh-velocity / -1 Jacobian slabs when the caller
        has none (static mesh); built once and kept."""
        if wq is None:
            if self._wq0 is None:
                gf = self.sys.ops.gf
                self._wq0 = self.pack_elem(
                    gf.wdetJ.new_zeros(gf.wdetJ.shape + (gf.invJ.shape[-1],)),
                    "zero")
            wq = self._wq0
        if gcl is None:
            if self._J0 is None:
                self._J0 = self.pack_elem(
                    torch.full_like(self.sys.ops.gf.wdetJ, -1.0), "dup")
            gcl = (self._J0, self._J0)
        return wq, gcl

    # -- layout converters ----------------------------------------------------

    def to_dist2(self, T, p, rank=None):
        """Rank ``rank``'s (this rank's by default) two-field slab
        [T_own | p_own] (2 nown_max,) of global (n,) T and p, on the mesh's
        device."""
        r = self.mesh.rank if rank is None else rank
        T = torch.as_tensor(T, device=self.device)
        p = torch.as_tensor(p, device=self.device)
        own, k, m = self._owned[r], len(self._owned[r]), self.nown_max
        out = T.new_zeros(2 * m)
        out[:k] = T[own]
        out[m:m + k] = p[own]
        return out

    def from_dist2(self, y_slabs):
        """Global (T, p) from every rank's two-field slab stacked as
        (ndev, 2 nown_max) (``mesh.all_gather(y)``)."""
        y = torch.as_tensor(y_slabs, device=self.device).reshape(
            self.ndev, 2 * self.nown_max)
        T = y.new_zeros(self.n)
        p = y.new_zeros(self.n)
        m = self.nown_max
        for d, own in enumerate(self._owned):
            T[own] = y[d, :len(own)]
            p[own] = y[d, m:m + len(own)]
        return T, p

    def gather2(self, y):
        """Global (T, p) on every rank from this rank's slab (one
        ``all_gather``)."""
        return self.from_dist2(self.mesh.all_gather(y))

    def per_device_floats(self):
        """Peak per-rank two-field vector length (owned + ghost)."""
        return 2 * self.n_loc

    # -- local pieces -----------------------------------------------------------

    def _halo2(self, y_own2):
        """This rank's [T_own; p_own] slab -> halo-extended (2, n_loc)
        through one stacked interface all_reduce."""
        dp = self.part
        return halo_forward(y_own2.reshape(2, dp.nown_max), self.pub_src,
                            self.pub_dst, self.ghost_src, dp.n_interface,
                            dp.nghost_max, self.mesh)

    def _reverse2(self, yT, yp):
        """Local (n_loc,) contributions of both fields -> the owned slab
        (2 nown_max,) through one stacked interface all_reduce."""
        dp = self.part
        return halo_reverse(torch.stack([yT, yp]), self.pub_src_rev,
                            self.pub_dst, self.ghost_src, dp.n_interface,
                            dp.nown_max, self.mesh).reshape(-1)

    def _elem_res(self, dt):
        return self.sys.elem_residual_fn(dt, gcl_enabled=self.gcl_enabled,
                                         ale_toggles=self.ale_toggles)

    def _elem_args(self, Tloc, ploc, To, po, Xo, wq, gcl):
        wq, (Jo, Jn) = self._ale_defaults(wq, gcl)
        ed = self.eldofs_loc
        return (Tloc[ed], ploc[ed], self.invJ, self.wdetJ, To, po, Xo, wq,
                Jo, Jn)

    def _face_args(self, Tloc, ploc, Xo):
        f = self._f
        ed = f["eldofs_f"]
        return (Tloc[ed], ploc[ed], f["Bf"], f["Gf"], f["invJf"], f["nrm"],
                f["wdS"], Xo[f["elem_local"], 0])

    # -- residual -------------------------------------------------------------

    def residual(self, y, To, po, Xo, dt, bc=None, wq=None, gcl=None):
        """BC-masked residual slab of this rank's two-field slab ``y``;
        old-state slabs To/po/Xo (and the optional ALE wq / GCL
        (J_old, J_new) slabs) from ``pack_elem``."""
        Tloc, ploc = self._halo2(y)
        rT_e, rp_e = torch.func.vmap(self._elem_res(dt))(
            *self._elem_args(Tloc, ploc, To, po, Xo, wq, gcl))
        yT = fixed_order_scatter(rT_e, self.slots)
        if self.seb is not None:
            rTf = torch.func.vmap(self.sys.seb_face_res_fn(bc, *self.seb))(
                *self._face_args(Tloc, ploc, Xo))
            yT = yT + fixed_order_scatter(rTf, self.fslots)
        y2 = self._reverse2(yT, fixed_order_scatter(rp_e, self.slots))
        return torch.where(self.mask_own2, 0.0, y2)

    # -- Jacobian preparation ----------------------------------------------------

    def prepare(self, y, To, po, Xo, dt, bc=None, wq=None, gcl=None):
        """AD-assemble, BC-eliminate and equilibrate this rank's element
        blocks; returns (Je_s, pb_own (nown_max, 4) point-block factors,
        s_own (2 nown_max,) scaling), all this rank's."""
        dp = self.part
        n_loc, nown, nd = dp.n_loc, dp.nown_max, self.nd
        Tloc, ploc = self._halo2(y)
        Je = element_blocks(self._elem_res(dt), *self._elem_args(
            Tloc, ploc, To, po, Xo, wq, gcl))
        if self.seb is not None:
            Fe = face_blocks(self.sys.seb_face_res_fn(bc, *self.seb),
                             *self._face_args(Tloc, ploc, Xo))
            Je = fold_face_blocks(Je, Fe, self.face_slots, nd)
        ed = self.eldofs_loc

        def gather_loc(x):
            return torch.cat([x[:n_loc][ed], x[n_loc:][ed]], dim=1)

        def scatter_loc(y_e):
            return torch.cat([fixed_order_scatter(y_e[:, :nd], self.slots),
                              fixed_order_scatter(y_e[:, nd:], self.slots)])

        def assemble2(v):
            return halo_assemble(v.reshape(2, n_loc), self.pub_src,
                                 self.pub_dst, self.pub_src_rev,
                                 self.ghost_src, dp.n_interface, nown,
                                 self.mesh).reshape(-1)

        Je_s, pb, s = equilibrated_block_factors(
            Je, self.lmask, self.mask2_loc, gather_loc, scatter_loc, nd,
            n_loc, reduce_fn=assemble2)
        # owned-slab views for the distributed GMRES
        return (Je_s, pb[:, :nown].T.contiguous(),
                torch.cat([s[:nown], s[n_loc:n_loc + nown]]))

    # -- linear solve --------------------------------------------------------------

    def matvec(self, Je_s, y):
        """The distributed equilibrated matvec of this rank's slab, the
        essential and pad rows pinned to the identity."""
        nd, ed = self.nd, self.eldofs_loc
        Tloc, ploc = self._halo2(y)
        y_e = torch.einsum("eij,ej->ei", Je_s,
                           torch.cat([Tloc[ed], ploc[ed]], dim=1))
        y2 = self._reverse2(fixed_order_scatter(y_e[:, :nd], self.slots),
                            fixed_order_scatter(y_e[:, nd:], self.slots))
        return torch.where(self.mask_own2, y, y2)

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        """Distributed GMRES solve of J dx = b (factors from ``prepare``);
        b and x are this rank's two-field slabs."""
        Je_s, pb_own, s_own = factors
        nown = self.nown_max

        def M(r):
            rT, rp = r[:nown], r[nown:]
            return torch.cat([pb_own[:, 0] * rT + pb_own[:, 1] * rp,
                              pb_own[:, 2] * rT + pb_own[:, 3] * rp])

        res = gmres(lambda v: self.matvec(Je_s, v), s_own * b, M=M,
                    rtol=float(rtol), atol=float(atol), restart=self.restart,
                    maxiter=self.maxiter, reduce=self.mesh.all_reduce)
        return res._replace(x=s_own * res.x)

    # -- one full Newton iterate ---------------------------------------------------

    def newton_step(self, y, To, po, Xo, dt, rtol=1e-10, bc=None, wq=None,
                    gcl=None):
        """One distributed Newton iterate on this rank's two-field slab;
        returns (y', |R|, GMRES restart cycles).  Essential DOFs are held
        fixed (the caller pre-sets their values in y)."""
        R = self.residual(y, To, po, Xo, dt, bc=bc, wq=wq, gcl=gcl)
        fac = self.prepare(y, To, po, Xo, dt, bc=bc, wq=wq, gcl=gcl)
        res = self.solve(fac, -R, rtol=rtol)
        return y + res.x, self.mesh.norm(R), res.iters
