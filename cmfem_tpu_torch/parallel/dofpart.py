"""DOF-partitioned distributed operator: memory per rank ∝ 1/N.

Port of ``cmfem_tpu/parallel/dofpart.py`` on ``torch.distributed``.  The
replicated-vector scheme of ``parallel.sharding`` keeps the whole DOF
vector on every rank; here, as with the reference's
``ParFiniteElementSpace`` true DOFs:

- elements are grouped by an RCB partition (``parallel.partition``);
- every DOF is owned by the lowest-numbered part that touches it; each rank
  stores its owned slab plus ghost copies of the partition-interface DOFs
  its elements touch;
- an apply publishes the owned interface values into one interface-length
  vector (each slot written by its one owner, so the all_reduce is a
  broadcast), gathers the ghosts, runs the element-local B^T D B, scatters
  locally (in a fixed order, ``ops.assembly.fixed_order_scatter``),
  and adds the ghost contributions back to their owners through a second
  interface all_reduce: two interface-sized collectives per apply.

Where the JAX package holds one global (ndev * nown_max,) array sharded
over the mesh, each rank here holds its own (nown_max,) slab (zero above
its ``nown[rank]`` owned values).  ``to_dist`` takes this rank's slab of a
global vector; ``from_dist`` rebuilds the global vector on every rank with
one ``all_gather``.  Dots and norms are the sums of the ranks' local ones
(``dot``/``norm``, to pass to ``solvers.krylov.cg``): pads are zero, so
they equal the JAX package's reductions over the padded global array.
``DofPartition`` (numpy) is a copy of the JAX class: its maps are the same
integers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assembly import dof_slots, fixed_order_scatter
from .partition import partition_elements
from .sharding import DeviceMesh, operator_blocks, qp_block_apply


class DofPartition:
    """Element/DOF ownership shared by every DOF-partitioned kernel: RCB
    element parts, lowest-part DOF ownership, per-rank [owned | ghost]
    local index spaces, and the interface publish/gather maps that make a
    halo exchange one all_reduce over an interface-length vector."""

    def __init__(self, eldofs, nglobal, ndev, parts=None, mesh=None):
        ed = np.asarray(eldofs, dtype=np.int64)
        ne, nd = ed.shape
        self.nglobal = int(nglobal)
        self.ndev = int(ndev)
        self.nd = nd
        if parts is None:
            parts = partition_elements(mesh, ndev)
        parts = np.asarray(parts, dtype=np.int64)
        if len(parts) != ne:
            raise ValueError(f"parts has {len(parts)} entries for {ne} "
                             "elements")
        if parts.min() < 0 or parts.max() >= ndev:
            # out-of-range parts would be dropped by the packing loops
            # below: a wrong apply with no error
            raise ValueError(f"parts ids must lie in [0, {ndev}); got "
                             f"[{parts.min()}, {parts.max()}]")
        self.parts = parts

        # -- ownership: lowest part touching each dof ----------------------
        owner = np.full(nglobal, ndev, dtype=np.int64)
        for d in range(ndev):
            dofs_d = np.unique(ed[parts == d])
            owner[dofs_d] = np.minimum(owner[dofs_d], d)
        if owner.max() >= ndev:
            raise ValueError("a DOF is touched by no element")
        self.owner = owner

        # interface dofs: touched by >= 2 parts (global slot numbering)
        touch = np.zeros((nglobal,), dtype=np.int64)
        touched_by = [np.unique(ed[parts == d]) for d in range(ndev)]
        for dofs_d in touched_by:
            touch[dofs_d] += 1
        iface_global = np.nonzero(touch >= 2)[0]
        nif = len(iface_global)
        self.n_interface = nif
        if2slot = np.full(nglobal, -1, dtype=np.int64)
        if2slot[iface_global] = np.arange(nif)

        # -- per-rank owned / ghost layouts ---------------------------------
        owned = [np.nonzero(owner == d)[0] for d in range(ndev)]
        nown_max = max(1, max(len(o) for o in owned))
        self.nown_max = nown_max
        self.nown = np.array([len(o) for o in owned])
        g2loc = np.full(nglobal, -1, dtype=np.int64)
        for d in range(ndev):
            g2loc[owned[d]] = np.arange(len(owned[d]))
        self.owned = owned

        ghosts = []
        for d in range(ndev):
            gd = touched_by[d][owner[touched_by[d]] != d]
            ghosts.append(gd)
        nghost_max = max(1, max(len(g) for g in ghosts))
        self.nghost_max = nghost_max
        self.ghosts = ghosts
        self.n_loc = nown_max + nghost_max

        # per-rank global dof -> local [owned | ghost] slot (-1 = absent)
        ne_max = max(1, int(np.bincount(parts, minlength=ndev).max()))
        self.ne_max = ne_max
        self.elem_idx = [np.nonzero(parts == d)[0] for d in range(ndev)]
        self.loc_maps = []
        eldofs_loc = np.zeros((ndev, ne_max, nd), dtype=np.int64)
        for d in range(ndev):
            loc = np.full(nglobal, -1, dtype=np.int64)
            loc[owned[d]] = np.arange(len(owned[d]))
            loc[ghosts[d]] = nown_max + np.arange(len(ghosts[d]))
            self.loc_maps.append(loc)
            idx = self.elem_idx[d]
            eldofs_loc[d, :len(idx)] = loc[ed[idx]]
        self.eldofs_loc_np = eldofs_loc

        # forward-exchange publish maps: (local owned idx, iface slot) for
        # this rank's owned interface dofs; pad writes go to a dead slot
        npub_max = max(1, max(
            int(np.sum(owner[iface_global] == d)) for d in range(ndev))
            if nif else 1)
        pub_src = np.full((ndev, npub_max), 0, dtype=np.int64)
        pub_dst = np.full((ndev, npub_max), nif, dtype=np.int64)  # dead
        for d in range(ndev):
            mine = iface_global[owner[iface_global] == d]
            pub_src[d, :len(mine)] = g2loc[mine]
            pub_dst[d, :len(mine)] = if2slot[mine]
        # pad-slot reads of x_own[pub_src] hit slot 0 but land in the dead
        # iface slot; the reverse adds of the dead slot target a dead owned
        # slot instead of owned slot 0
        self.pub_src_rev_np = np.where(pub_dst < nif, pub_src, nown_max)
        self.pub_src_np = pub_src
        self.pub_dst_np = pub_dst

        ghost_src = np.full((ndev, nghost_max), nif, dtype=np.int64)
        for d in range(ndev):
            ghost_src[d, :len(ghosts[d])] = if2slot[ghosts[d]]
        self.ghost_src_np = ghost_src

    def pack_elem(self, a, fill="zero"):
        """Group an (ne, ...) per-element array into padded per-rank batches
        (ndev, ne_max, ...); pad rows are zeros (``fill="zero"``, for
        quadrature weights and operator data) or a copy of the rank's first
        element (``"dup"``, for state that must stay finite)."""
        a = np.asarray(a)
        out = np.zeros((self.ndev, self.ne_max) + a.shape[1:], a.dtype)
        for d in range(self.ndev):
            idx = self.elem_idx[d]
            out[d, :len(idx)] = a[idx]
            if fill == "dup":
                out[d, len(idx):] = a[idx[0] if len(idx) else 0]
        return out

    def to_dist(self, x_global, rank: int):
        """Global entity-numbered (nglobal,) -> rank ``rank``'s owned slab
        (nown_max,), zero padded (numpy)."""
        x = np.asarray(x_global)
        out = np.zeros(self.nown_max, x.dtype)
        out[:len(self.owned[rank])] = x[self.owned[rank]]
        return out

    def from_dist(self, x_slabs):
        """(ndev, nown_max) owned slabs (numpy) -> global (nglobal,)."""
        x = np.asarray(x_slabs).reshape(self.ndev, self.nown_max)
        out = np.zeros(self.nglobal, x.dtype)
        for d in range(self.ndev):
            out[self.owned[d]] = x[d, :len(self.owned[d])]
        return out


def halo_forward(x_own, pub_src, pub_dst, ghost_src, nif, nghost_max,
                 mesh: DeviceMesh):
    """Extend this rank's owned slab (..., nown_max) with its ghost values
    through one interface all_reduce -> (..., nown_max + nghost_max).
    (Pad ghost slots read the last interface slot, as the JAX package's
    clamped gather does; no element reads them.)"""
    pub = x_own.new_zeros(x_own.shape[:-1] + (nif + 1,))
    pub.index_add_(-1, pub_dst, x_own[..., pub_src])
    pub = mesh.all_reduce(pub)[..., :nif]
    if nif:
        gh = pub[..., torch.clamp(ghost_src, max=nif - 1)]
    else:
        gh = x_own.new_zeros(x_own.shape[:-1] + (nghost_max,))
    return torch.cat([x_own, gh], dim=-1)


def halo_reverse(y_loc, pub_src_rev, pub_dst, ghost_src, nif, nown_max,
                 mesh: DeviceMesh):
    """Add the ghost-slot contributions of local vectors (..., nown_max +
    nghost_max) onto their owners (one all_reduce) -> (..., nown_max)."""
    gcon = y_loc.new_zeros(y_loc.shape[:-1] + (nif + 1,))
    gcon.index_add_(-1, ghost_src, y_loc[..., nown_max:])
    gcon = mesh.all_reduce(gcon)
    y_ext = torch.cat([y_loc[..., :nown_max],
                       y_loc.new_zeros(y_loc.shape[:-1] + (1,))], dim=-1)
    y_ext.index_add_(-1, pub_src_rev,
                     gcon[..., torch.clamp(pub_dst, max=nif)])
    return y_ext[..., :nown_max]


def halo_assemble(v_loc, pub_src, pub_dst, pub_src_rev, ghost_src, nif,
                  nown_max, mesh: DeviceMesh):
    """Fully assemble additive local contributions (..., nown_max +
    nghost_max) so that every copy (owner and ghosts) holds the global sum:
    one all_reduce.  Pad ghost slots receive dead-slot values; no element
    map reads them."""
    pub = v_loc.new_zeros(v_loc.shape[:-1] + (nif + 1,))
    pub.index_add_(-1, pub_dst, v_loc[..., pub_src])
    pub.index_add_(-1, ghost_src, v_loc[..., nown_max:])
    pub = mesh.all_reduce(pub)
    own = torch.cat([v_loc[..., :nown_max],
                     v_loc.new_zeros(v_loc.shape[:-1] + (1,))], dim=-1)
    own[..., pub_src_rev] = pub[..., torch.clamp(pub_dst, max=nif)]
    return torch.cat([own[..., :nown_max], pub[..., ghost_src]], dim=-1)


class DofPartitionedOperator:
    """Element- and DOF-partitioned matrix-free apply of a
    (mass+)diffusion(+convection) operator over the ranks of ``mesh``.

    Rank r holds its owned DOF values as a (nown_max,) slab, slots
    [0, nown[r]) and zeros above; ``to_dist``/``from_dist`` convert to and
    from the global entity numbering; ``dot``/``norm`` are the reductions
    of that layout, for ``solvers.krylov.cg``."""

    def __init__(self, ops, data, mesh: DeviceMesh, parts=None):
        self.ops = ops
        self.mesh = mesh
        self.ndev = mesh.size
        fes = ops.fes
        self.nglobal = fes.nscalar
        dp = DofPartition(fes.element_dofs, self.nglobal, self.ndev,
                          parts=parts, mesh=fes.mesh)
        self.part = dp
        self.n_interface = dp.n_interface
        self.nown_max = dp.nown_max
        self.nghost_max = dp.nghost_max
        self.nown = dp.nown
        self.owned = dp.owned
        self.ne_max = dp.ne_max
        r, dev = mesh.rank, mesh.device
        idx = lambda a: torch.as_tensor(a[r], device=dev)
        self.eldofs_loc = idx(dp.eldofs_loc_np)
        # padding elements point at owned slot 0 with zero D blocks
        self.blocks = {
            k: None if v is None else torch.as_tensor(
                dp.pack_elem(v.cpu().numpy(), fill="zero")[r], device=dev)
            for k, v in operator_blocks(data).items()}
        self.pub_src = idx(dp.pub_src_np)
        self.pub_dst = idx(dp.pub_dst_np)
        self.pub_src_rev = idx(dp.pub_src_rev_np)
        self.ghost_src = idx(dp.ghost_src_np)
        self.B = ops.B.to(dev)
        self.G = ops.G.to(dev)
        self.slots = dof_slots(self.eldofs_loc, dp.n_loc)
        # from_dist: slab slot d * nown_max + i -> global DOF owned[d][i]
        self._owned_g = torch.as_tensor(np.concatenate(dp.owned),
                                        device=dev)
        self._owned_s = torch.as_tensor(np.concatenate(
            [d * dp.nown_max + np.arange(len(o))
             for d, o in enumerate(dp.owned)]), device=dev)

    # -- layout converters ----------------------------------------------------

    def to_dist(self, x_global):
        """Global entity-numbered (nglobal,) -> this rank's owned slab."""
        if torch.is_tensor(x_global):
            x = x_global.to(self.mesh.device)
            out = x.new_zeros(self.nown_max)
            own = torch.as_tensor(self.owned[self.mesh.rank],
                                  device=x.device)
            out[:len(own)] = x[own]
            return out
        return torch.as_tensor(self.part.to_dist(x_global, self.mesh.rank),
                               device=self.mesh.device)

    def from_dist(self, x_dist):
        """This rank's owned slab -> the global entity-numbered (nglobal,)
        vector, on every rank (one all_gather)."""
        slabs = self.mesh.all_gather(x_dist).reshape(-1)
        out = slabs.new_zeros(self.nglobal)
        out[self._owned_g] = slabs[self._owned_s]
        return out

    def dot(self, a, b):
        return self.mesh.dot(a, b)

    def norm(self, v):
        return self.mesh.norm(v)

    def __call__(self, x_dist):
        nif = self.n_interface
        xloc = halo_forward(x_dist, self.pub_src, self.pub_dst,
                            self.ghost_src, nif, self.nghost_max, self.mesh)
        y_e = qp_block_apply(self.B, self.G, xloc[self.eldofs_loc],
                             *self.blocks.values())
        y_loc = fixed_order_scatter(y_e, self.slots)
        return halo_reverse(y_loc, self.pub_src_rev, self.pub_dst,
                            self.ghost_src, nif, self.nown_max, self.mesh)

    def per_device_floats(self):
        """Peak per-rank vector length (owned + ghost): the memory-scaling
        diagnostic, ∝ nglobal / ndev + interface."""
        return self.nown_max + self.nghost_max
