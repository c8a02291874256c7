"""Numberings and arrays carried between the port's objects and the JAX
package's.

The JAX package's arrays, taken out with ``np.asarray``, become the port's
tensors here, so both packages can be made to compute the same thing:

- ``operator_data_from_numpy``: quadrature-point data (d00, d01, d10, d11);
- ``vector_qp_from_numpy``: the quadrature-point stiffness C (ne, nq, v, d,
  v, d) of a ``VectorBilinearForm``;
- ``SumFactoredOperator.from_arrays`` (in ``ops.sumfact``): an operator from
  D and Dz in the lattice layout, the axis matrices and the flags;
- ``pa_operator_from_arrays``: a PAOperator or StructuredPAOperator from
  ``pack_qp_blocks_T``'s (Dflat, BG);
- ``geometric_mg_from_arrays``: a GeometricMG whose levels carry the other
  package's data, diagonal, mask, transfer stencils and ``lmax`` (the two
  packages' power iterations start from different random vectors, so only
  carried-over ``lmax`` makes their V-cycles comparable);
- ``ablation_state_from_numpy``: an ``AblationState`` (the per-QP reaction
  extents and the element diagnostics) from the JAX package's, so both
  packages compute the ablation residual and Jacobian from one state (the
  material crosses as the same deck mapping, ``TacotMaterial.from_mapping``).

A case-2.1 run's state crosses as a restart checkpoint: the port's
``apps.ablation_case2_1.save_restart``/``load_restart`` write and read the
JAX driver's npz keys and dtypes, so either package resumes from the
other's checkpoint.

``lattice_index`` is the entity -> lattice DOF permutation of a
``make_cartesian_mesh_3d`` space, taken from the topology (element
numbering and local tensor indices), not from node positions, so it holds
on a distorted lattice too.  ``lattice_diagonal`` moves an entity-numbered
Jacobi diagonal to the lattice with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.fespace import FESpace
from .ops.assembly import OperatorData
from .ops.partial import (
    PAOperator,
    StructuredGrid3D,
    StructuredPAOperator,
    _tensor,
)


def operator_data_from_numpy(d00, d01, d10, d11, *, device,
                             dtype=torch.float64) -> OperatorData:
    """OperatorData from numpy blocks (any of them may be None)."""
    cv = lambda a: None if a is None else _tensor(a, device, dtype)
    return OperatorData(cv(d00), cv(d01), cv(d10), cv(d11))


def vector_qp_from_numpy(C, *, device, dtype=torch.float64) -> torch.Tensor:
    """A ``VectorBilinearForm``'s assembled stiffness C (ne, nq, v, d, v, d)
    from a numpy array, for ``VectorBilinearForm.apply`` and
    ``assemble_diagonal``."""
    C = _tensor(C, device, dtype)
    if C.ndim != 6 or C.shape[2:4] != C.shape[4:6]:
        raise ValueError(f"C must be (ne, nq, v, d, v, d), got {tuple(C.shape)}")
    return C


def lattice_index(fes: FESpace, grid: StructuredGrid3D) -> np.ndarray:
    """(nscalar,) int64: the lattice number of every entity-numbered DOF.

    Element e = (k*ny + j)*nx + i (the numbering of
    ``make_cartesian_mesh_3d``) holds, at its local DOF with tensor index
    (a, b, c), the lattice DOF (k*p + c, j*p + b, i*p + a).  Raises
    ValueError when the space is not such a lattice (a DOF reached at two
    lattice points, or a lattice point never reached)."""
    nx, ny, nz = grid.n
    p = grid.p
    ti = fes.ref._tensor_idx  # (nd, 3) (a, b, c)
    e = np.arange(grid.ne)
    i, j, k = e % nx, (e // nx) % ny, e // (nx * ny)
    lat_el = (((k[:, None] * p + ti[None, :, 2]) * grid.NY
               + j[:, None] * p + ti[None, :, 1]) * grid.NX
              + i[:, None] * p + ti[None, :, 0])  # (ne, nd)
    eldofs = np.asarray(fes.element_dofs, dtype=np.int64)
    if fes.nscalar != grid.ndofs or eldofs.shape != lat_el.shape:
        raise ValueError(f"space with {fes.nscalar} DOFs and element DOFs "
                         f"{eldofs.shape} is not the {grid.n} order-{p} "
                         "lattice")
    lat = np.full(fes.nscalar, -1, dtype=np.int64)
    lat[eldofs] = lat_el
    if (lat[eldofs] != lat_el).any() or len(np.unique(lat)) != grid.ndofs \
            or lat.min() < 0:
        raise ValueError("element DOFs do not form the lattice of the grid")
    return lat


def lattice_diagonal(diag_entity, fes: FESpace, grid: StructuredGrid3D, *,
                     device, dtype=torch.float32):
    """The entity-numbered diagonal (nscalar,) in lattice numbering."""
    lat = torch.as_tensor(lattice_index(fes, grid), device=device)
    diag = torch.zeros(grid.ndofs, dtype=dtype, device=device)
    diag[lat] = _tensor(diag_entity, device, dtype)
    return diag


def pa_operator_from_arrays(Dflat, BG, eldofs=None,
                            grid: StructuredGrid3D | None = None, *,
                            nscalar: int | None = None, device,
                            dtype=torch.float32):
    """A PAOperator (with ``eldofs`` (ne, nd) and ``nscalar``) or a
    StructuredPAOperator (with ``grid``) from ``pack_qp_blocks_T``'s output
    of either package: Dflat (m*m, nq, ne) and BG (m*nq, nd), numpy arrays
    or tensors."""
    if grid is not None and eldofs is None and nscalar is None:
        return StructuredPAOperator.from_arrays(Dflat, BG, grid,
                                                device=device, dtype=dtype)
    if grid is None and eldofs is not None and nscalar is not None:
        return PAOperator.from_arrays(Dflat, BG, eldofs, nscalar,
                                      device=device, dtype=dtype)
    raise ValueError("pass eldofs and nscalar (PAOperator) or grid alone "
                     "(StructuredPAOperator)")


def geometric_mg_from_arrays(specs, make_form, levels, *, quad_order=None,
                             device, dtype=torch.float64):
    """A ``GeometricMG`` over ``specs`` ((mesh, order) fine -> coarse) whose
    level state is given as arrays: ``levels[k]`` is a dict with ``data``
    (the (d00, d01, d10, d11) blocks, any of them None), ``diag``, ``mask``,
    ``lmax`` and, for every level but the coarsest, ``Pd`` and ``Pw``.
    ``make_form(ops)`` builds each level's form (its tabulations apply the
    data); nothing is assembled, located or estimated here."""
    from .ops.assembly import SpaceOps
    from .solvers.multigrid import GeometricMG

    out = []
    for (mesh_l, order_l), a in zip(specs, levels, strict=True):
        fes = FESpace(mesh_l, order_l)
        ops = SpaceOps(fes, quad_order=quad_order or max(2, 2 * order_l),
                       device=device, dtype=dtype)
        lvl = {
            "form": make_form(ops),
            "data": operator_data_from_numpy(*a["data"], device=device,
                                             dtype=dtype),
            "n": fes.nscalar,
            "diag": _tensor(a["diag"], device, dtype),
            "mask": _tensor(a["mask"], device, torch.bool),
            "lmax": float(a["lmax"]),
        }
        if a.get("Pd") is not None:
            lvl["Pd"] = _tensor(a["Pd"], device, torch.int64)
            lvl["Pw"] = _tensor(a["Pw"], device, dtype)
        out.append(lvl)
    return GeometricMG(out)


_STATE_FIELDS = ("tau_elem", "rho_elem", "pi_elem", "mdot_elem",
                 "extent_elem", "degree_char_elem",
                 "char_density_fraction_elem")


def ablation_state_from_numpy(state, *, device, dtype=torch.float64):
    """The port's ``AblationState`` from the JAX package's (its arrays read
    with ``np.asarray``): the extents (ne, nq, nr) become a tensor on
    ``device`` in ``dtype``, the element diagnostics numpy copies."""
    from .physics.ablation import AblationState

    host = lambda a: None if a is None else np.array(np.asarray(a),
                                                     dtype=np.float64)
    return AblationState(
        extent=_tensor(np.asarray(state.extent), device, dtype),
        **{k: host(getattr(state, k)) for k in _STATE_FIELDS},
        pi_qp=host(state.pi_qp))
