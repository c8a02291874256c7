"""Distributed operator apply: elements split over the ranks of a world.

Port of ``cmfem_tpu/parallel/sharding.py`` on ``torch.distributed``.  The
JAX package holds one global array sharded over a ``jax.sharding.Mesh`` of
devices in one process; here each rank is a process (``parallel.launch``)
that holds its own slab of the elements, and the mesh is ``DeviceMesh``:
the rank, the world size, the device and the process group.  ``psum``
becomes ``dist.all_reduce``.

``ShardedPoissonApply`` keeps the whole DOF vector on every rank (vectors
are replicated, as in the JAX package); an apply is

    local gather -> ``qp_block_apply`` -> local scatter -> one all_reduce

which is T^T A T with the shared-DOF exchange as one collective.  The
local scatter sums each DOF's element slots in a fixed order
(``ops.assembly.dof_slots``), not with ``index_add_``, whose atomics on the
card add in an order that changes from run to run; so every rank, and
every repeat, computes the same bits, and a CG exit cannot depend on it.
Reductions (dots, norms) of replicated vectors are rank-local and equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import require_cuda
from ..ops.assembly import dof_slots, fixed_order_scatter, qp_block_apply


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-axis mesh of ranks: this process's rank and device, the world
    size and the process group, with the reductions over it."""

    rank: int
    size: int
    device: torch.device
    group: object
    axis: str = "dd"

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """(size, *t.shape): every rank's ``t``, in rank order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def dot(self, a, b):
        """The sum over the ranks of the local dots of two slabs."""
        return self.all_reduce(torch.dot(a.reshape(-1), b.reshape(-1)))

    def norm(self, v):
        """sqrt(dot(v, v)): the 2-norm of the layout the slabs make up."""
        return torch.sqrt(self.dot(v, v))


def make_device_mesh(n_devices: int | None = None, axis: str = "dd", *,
                     device=None) -> DeviceMesh:
    """The mesh of the initialised world (``parallel.launch.init_rank``).

    Raises when there is no world, when it is smaller than ``n_devices``
    (an N-way run that silently ran on fewer ranks would be a false green),
    or larger (a mesh over part of the world is not supported: start it
    with ``n_devices`` ranks), and, on a CUDA device, when this torch has
    no NCCL.  ``device`` defaults to the card of this rank (``cuda:rank %
    device_count``); CPU ranks pass ``device="cpu"``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_device_mesh: no torch.distributed world; "
                           "start the ranks with parallel.launch")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size < n_devices:
        raise RuntimeError(
            f"make_device_mesh: requested {n_devices} ranks but only "
            f"{size} exist; start the world with {n_devices} ranks")
    if n_devices is not None and size > n_devices:
        raise ValueError(
            f"make_device_mesh: requested {n_devices} ranks of a world of "
            f"{size}; a mesh over part of the world is not supported")
    if device is None:
        require_cuda()
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("make_device_mesh: CUDA ranks need NCCL, which "
                           "this torch build lacks")
    return DeviceMesh(rank, size, device, dist.group.WORLD, axis)


def _tensor(a, device, dtype=None):
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def shard_elements(mesh: DeviceMesh, *arrays):
    """Pad the leading (element) axis to a multiple of the mesh size and
    take this rank's contiguous slab of it, on the mesh's device.  Padding
    is zero-filled for every array: pad elements map all their DOFs to DOF
    0, which is only safe because callers pass zero-padded operator data
    (their contributions are exactly zero).  Returns (this rank's slabs,
    ne_pad)."""
    n = mesh.size
    ne = arrays[0].shape[0]
    ne_pad = ((ne + n - 1) // n) * n
    per = ne_pad // n
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    outs = []
    for a in arrays:
        a = _tensor(a, mesh.device)
        if ne_pad > ne:
            a = torch.cat([a, a.new_zeros((ne_pad - ne,) + a.shape[1:])])
        outs.append(a[lo:hi].contiguous())
    return outs, ne_pad


def operator_blocks(data):
    """{"d00": tensor or None, ...}: the QP blocks of an OperatorData."""
    return {name: getattr(data, name) for name in ("d00", "d01", "d10",
                                                   "d11")}


class ShardedPoissonApply:
    """Element-split matrix-free apply of a (mass+)diffusion(+convection)
    operator; ``__call__(u)`` takes and returns the replicated global
    vector.  Pad elements carry zero operator data and contribute nothing.
    """

    def __init__(self, ops, data, mesh: DeviceMesh):
        self.ops = ops
        self.mesh = mesh
        self.nscalar = ops.fes.nscalar
        blocks = operator_blocks(data)
        names = [k for k, v in blocks.items() if v is not None]
        eldofs = np.asarray(ops.fes.element_dofs, dtype=np.int64)
        (self.eldofs, *sharded), self.ne_pad = shard_elements(
            mesh, eldofs, *[blocks[k] for k in names])
        self.blocks = dict.fromkeys(blocks)
        self.blocks.update(zip(names, sharded))
        self.B = ops.B.to(mesh.device)
        self.G = ops.G.to(mesh.device)
        self.slots = dof_slots(self.eldofs, self.nscalar)

    def __call__(self, u):
        y_e = qp_block_apply(self.B, self.G, u[self.eldofs],
                             *self.blocks.values())
        return self.mesh.all_reduce(fixed_order_scatter(y_e, self.slots))
