"""Distributed sum-factorized operator: the DOF lattice split along z.

Port of ``cmfem_tpu/ops/sumfact_sharded.py`` on ``torch.distributed``.
Rank d owns the element slab k in [k0_d, k1_d); its DOF slab is planes
[k0_d p, k1_d p] inclusive: the slab-boundary plane is held by both
neighbours (the overlapping decomposition of a tensor grid).  An apply:

  - the x/y contractions are plane-local (no communication);
  - the forward z-contraction reads only local planes (the duplicated
    boundary plane covers the shared elements);
  - the transposed z-contraction leaves partial sums on the two boundary
    planes, which the neighbours add with one exchange per direction
    (``dist.batch_isend_irecv``, one (NY, NX) plane each way), where the JAX
    package uses ``ppermute``.

Each rank holds its own (nplanes_loc, NY, NX) slab; the JAX package holds
the stacked (ndev * nplanes_loc, NY, NX) array sharded over its mesh.  CG
runs on the slabs with ``dot``/``norm``: the sums over the ranks of the
local dots, the duplicated planes counted on both ranks, as the JAX
package's plain dots over the stacked array count them (so that the
iteration counts match); ``ownership_weights`` gives the 1/2 weights of
the duplicated planes.  The per-slab contractions are torch einsums, as
the JAX package's are XLA einsums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import DeviceMesh
from .assembly import OperatorData, SpaceOps
from .sumfact import _PAIRS, SumFactoredOperator, _axis_matrices, _bwd, _fwd


class ShardedSumFactOperator:
    """Builds on ``SumFactoredOperator``'s packing; splits the z axis over
    the ranks of ``mesh`` (each rank keeps its Kz slab of D)."""

    def __init__(self, ops: SpaceOps, data: OperatorData, nx, ny, nz,
                 order: int, mesh: DeviceMesh, *, dtype=torch.float32):
        ndev = mesh.size
        if nz % ndev:
            raise ValueError(f"nz={nz} must divide by n_devices={ndev}")
        self.mesh = mesh
        self.ndev = ndev
        self.p = order
        self.dtype = dtype
        base = SumFactoredOperator(ops, data, nx, ny, nz, order,
                                   device=mesh.device, dtype=dtype)
        self.base = base
        self.NX, self.NY, self.NZ = base.NX, base.NY, base.NZ
        self.ndofs = base.ndofs
        p = order
        self.nz_loc = nz // ndev
        self.nplanes_loc = self.nz_loc * p + 1  # with the duplicated plane
        self.Kz_loc = base.Kz // ndev
        # local z-axis matrices (nz_loc q1, nz_loc p + 1): the same blocks on
        # every rank (uniform grid)
        Az, DAz = _axis_matrices(self.nz_loc, p, base.q1)
        to = lambda a: torch.as_tensor(a, dtype=dtype, device=mesh.device)
        self.Az_loc, self.DAz_loc = to(Az), to(DAz)
        self.Ax, self.DAx = base.Ax, base.DAx
        self.Ay, self.DAy = base.Ay, base.DAy
        # D is on the QP lattice (mm, Kz, Ky, Kx): this rank's Kz slab
        k0 = mesh.rank * self.Kz_loc
        self.D = base.D[:, k0:k0 + self.Kz_loc].contiguous()

    # -- vector layout -------------------------------------------------------

    def _k0(self, d):
        return d * self.nz_loc * self.p

    def to_sharded(self, u):
        """Global lattice vector (ndofs,) -> this rank's slab (nplanes_loc,
        NY, NX), the boundary planes included."""
        k0 = self._k0(self.mesh.rank)
        if torch.is_tensor(u):
            u3 = u.to(self.mesh.device).reshape(self.NZ, self.NY, self.NX)
            return u3[k0:k0 + self.nplanes_loc].clone()
        u3 = np.asarray(u).reshape(self.NZ, self.NY, self.NX)
        return torch.as_tensor(np.array(u3[k0:k0 + self.nplanes_loc]),
                               device=self.mesh.device)

    def from_sharded(self, us):
        """Inverse of ``to_sharded`` on every rank (one all_gather; a
        duplicated plane is taken from the upper slab, as in the JAX
        package)."""
        slabs = self.mesh.all_gather(us)
        out = us.new_zeros((self.NZ, self.NY, self.NX))
        for d in range(self.ndev):
            k0 = self._k0(d)
            out[k0:k0 + self.nplanes_loc] = slabs[d]
        return out.reshape(-1)

    def ownership_weights(self):
        """(nplanes_loc, 1, 1) weights of this rank's planes: a duplicated
        plane counts 1/2."""
        w = torch.ones((self.nplanes_loc, 1, 1), dtype=torch.float64,
                       device=self.mesh.device)
        if self.mesh.rank > 0:
            w[0] = 0.5
        if self.mesh.rank < self.ndev - 1:
            w[-1] = 0.5
        return w

    def dot(self, a, b):
        return self.mesh.dot(a, b)

    def norm(self, v):
        return self.mesh.norm(v)

    # -- apply ----------------------------------------------------------------

    def _halo_sum(self, y3):
        """Add the neighbours' partial sums on the duplicated planes: this
        rank's top plane to the right neighbour's bottom one and back."""
        rank, n, g = self.mesh.rank, self.ndev, self.mesh.group
        top, bot = y3[-1].clone(), y3[0].clone()
        # receive buffers shaped and typed like what the peer sends
        from_left = torch.empty_like(top) if rank > 0 else None
        from_right = torch.empty_like(bot) if rank < n - 1 else None
        p2p = []
        if rank < n - 1:
            p2p += [dist.P2POp(dist.isend, top, rank + 1, g),
                    dist.P2POp(dist.irecv, from_right, rank + 1, g)]
        if rank > 0:
            p2p += [dist.P2POp(dist.isend, bot, rank - 1, g),
                    dist.P2POp(dist.irecv, from_left, rank - 1, g)]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
        if from_left is not None:
            y3[0] += from_left
        if from_right is not None:
            y3[-1] += from_right
        return y3

    def _apply(self, u_loc, D_loc):
        Ax, DAx, Ay, DAy = self.Ax, self.DAx, self.Ay, self.DAy
        Az, DAz = self.Az_loc, self.DAz_loc
        m = self.base.m
        u3 = u_loc.to(self.dtype)
        V = [_fwd(u3, Ax, Ay, Az), _fwd(u3, DAx, Ay, Az),
             _fwd(u3, Ax, DAy, Az), _fwd(u3, Ax, Ay, DAz)]
        if self.base.compressed:
            W = [D_loc[0] * V[0]]
            for s in range(1, m):
                W[0] = W[0] + D_loc[s] * V[s]
            Wg = [None] * (m - 1)
            for k, (r, s) in enumerate(_PAIRS):
                plane = D_loc[m + k]
                t = plane * V[s]
                Wg[r - 1] = t if Wg[r - 1] is None else Wg[r - 1] + t
                if s != r:
                    t2 = plane * V[r]
                    Wg[s - 1] = t2 if Wg[s - 1] is None else Wg[s - 1] + t2
            W += Wg
        else:
            W = []
            for r in range(m):
                acc = D_loc[r * m] * V[0]
                for s in range(1, m):
                    acc = acc + D_loc[r * m + s] * V[s]
                W.append(acc)
        y3 = _bwd(W[0], Ax, Ay, Az)
        y3 = y3 + _bwd(W[1], DAx, Ay, Az)
        y3 = y3 + _bwd(W[2], Ax, DAy, Az)
        y3 = y3 + _bwd(W[3], Ax, Ay, DAz)
        if self.ndev > 1:
            y3 = self._halo_sum(y3)
        return y3

    def __call__(self, u_sharded):
        return self._apply(u_sharded, self.D)

    def bind(self):
        """(fn(u_loc, D_loc) -> y_loc, D_loc)."""
        return self._apply, self.D
