"""Essential (Dirichlet) boundary-condition elimination.

Port of ``cmfem_tpu/ops/bc.py``: MFEM ``FormLinearSystem`` semantics
(DIAG_ONE policy) as masked operator application, so the matrix-free path
never materializes the eliminated system.
"""

from __future__ import annotations

import numpy as np
import torch


class EssentialBC:
    """Mask-based essential-dof elimination for an n-dof scalar/vector space."""

    def __init__(self, n: int, ess_dofs, *, device):
        self.n = n
        ess = np.asarray(ess_dofs, dtype=np.int64).reshape(-1)
        mask = np.zeros(n, dtype=bool)
        mask[ess] = True
        self.ess_dofs = torch.as_tensor(ess, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.free = ~self.mask

    def constrain_operator(self, apply_fn):
        """A_c x = A x on free rows with x zeroed at essential dofs, plus
        identity on essential rows."""
        free, mask = self.free, self.mask

        def constrained(x):
            y = apply_fn(torch.where(free, x, 0.0))
            return torch.where(free, y, 0.0) + torch.where(mask, x, 0.0)

        return constrained

    def constrained_rhs(self, apply_fn, b, u_bc):
        """B = b - A u_bc on free rows; B[ess] = u_bc[ess].

        u_bc must carry the boundary values at essential dofs (its free
        entries are ignored)."""
        xb = torch.where(self.mask, u_bc, 0.0)
        B = b - apply_fn(xb)
        return torch.where(self.free, B, xb)

    def apply_values(self, x, u_bc):
        """Overwrite essential entries of x with u_bc values."""
        return torch.where(self.mask, u_bc, x)

    def zero_essential(self, x):
        return torch.where(self.free, x, 0.0)

    def constrain_dense(self, A, diag=1.0):
        """Row/col elimination on a dense matrix (direct-solve path)."""
        freef = self.free.to(A.dtype)
        A = A * freef[:, None] * freef[None, :]
        return A + torch.diag(torch.where(self.mask, diag, 0.0).to(A.dtype))
