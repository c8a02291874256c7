"""Arrays carried across from the JAX package into the port's objects.

The JAX package's arrays, taken out with ``np.asarray``, become the port's
tensors here, so both packages can be made to compute the same thing:

- ``operator_data_from_numpy``: quadrature-point data (d00, d01, d10, d11);
- ``SumFactoredOperator.from_arrays`` (in ``ops.sumfact``): an operator from
  D and Dz in the lattice layout, the axis matrices and the flags;
- ``lattice_diagonal``: an entity-numbered Jacobi diagonal moved to the
  lattice numbering of ``StructuredGrid3D``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.assembly import OperatorData
from .ops.partial import StructuredGrid3D
from .ops.sumfact import _tensor


def operator_data_from_numpy(d00, d01, d10, d11, *, device,
                             dtype=torch.float64) -> OperatorData:
    """OperatorData from numpy blocks (any of them may be None)."""
    cv = lambda a: None if a is None else _tensor(a, device, dtype)
    return OperatorData(cv(d00), cv(d01), cv(d10), cv(d11))


def lattice_diagonal(diag_entity, node_positions, grid: StructuredGrid3D, *,
                     device, dtype=torch.float32):
    """The entity-numbered diagonal (nscalar,) in lattice numbering.

    DOFs are matched by position: ``round(x * (NX - 1))`` per axis, which
    assumes the unit cube with nx = ny = nz (as ``__graft_entry__.entry``
    does)."""
    pos = np.round(np.asarray(node_positions) * (grid.NX - 1)).astype(np.int64)
    lat = (pos[:, 2] * grid.NY + pos[:, 1]) * grid.NX + pos[:, 0]
    diag = torch.zeros(grid.ndofs, dtype=dtype, device=device)
    diag[torch.as_tensor(lat, device=device)] = _tensor(diag_entity, device,
                                                        dtype)
    return diag
