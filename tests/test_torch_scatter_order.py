"""The fixed-order scatter (``SpaceOps.fix_scatter_order``, ROADMAP C10):
on the CPU it equals the ``index_add_`` scatter to roundoff and gives the
same forms' applies and diagonals; ``LaplacianSmoother`` (the case-2.2
mesh smoothing) uses it.  On the card (``gpu``) repeated smoothing solves
agree bit for bit, where ``index_add_``'s atomics made the iterates differ
at the ulp level between repeats (H100, chip_smoke phase 13e)."""

import numpy as np
import pytest
import torch

from cmfem_tpu_torch.core import FESpace, make_strip_mesh_2d
from cmfem_tpu_torch.motion.recession import LaplacianSmoother
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps


def _ops(device="cpu", geom="triangle"):
    return SpaceOps(FESpace(make_strip_mesh_2d(3, 20, geom=geom), 1),
                    device=device)


@pytest.mark.parametrize("geom", ["triangle", "quad"])
def test_fixed_order_scatter_equals_index_add(geom):
    plain, fixed = _ops(geom=geom), _ops(geom=geom).fix_scatter_order()
    rng = np.random.default_rng(0)
    y_e = torch.as_tensor(rng.standard_normal(tuple(plain.eldofs.shape)))
    torch.testing.assert_close(fixed.scatter(y_e), plain.scatter(y_e),
                               rtol=1e-15, atol=1e-15)
    u = torch.as_tensor(rng.standard_normal(plain.fes.nscalar))
    fa = BilinearForm(plain).add_diffusion(1.0).add_mass(2.0)
    fb = BilinearForm(fixed).add_diffusion(1.0).add_mass(2.0)
    da, db = fa.assemble(), fb.assemble()
    torch.testing.assert_close(fb.apply(db, u), fa.apply(da, u), rtol=1e-14,
                               atol=1e-14)
    torch.testing.assert_close(fb.assemble_diagonal(db),
                               fa.assemble_diagonal(da), rtol=1e-14,
                               atol=1e-14)


def test_laplacian_smoother_scatters_in_a_fixed_order():
    fes = FESpace(make_strip_mesh_2d(3, 20, geom="triangle"), 1)
    top, bottom = fes.boundary_dofs([3]), fes.boundary_dofs([1])
    sm = LaplacianSmoother(fes, top, bottom, device="cpu")
    assert sm.ops._slots is not None
    verts = torch.as_tensor(np.asarray(fes.mesh.vertices))
    v = torch.full((fes.nscalar,), 1e-4, dtype=torch.float64)
    a, b = sm.solve(verts, v), sm.solve(verts, v)
    assert a.iters == b.iters and torch.equal(a.x, b.x)
    assert a.converged


@pytest.mark.gpu
def test_cuda_smoothing_solves_repeat_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fes = FESpace(make_strip_mesh_2d(11, 239, geom="triangle"), 1)
    top, bottom = fes.boundary_dofs([3]), fes.boundary_dofs([1])
    sm = LaplacianSmoother(fes, top, bottom, device="cuda")
    verts = torch.as_tensor(np.asarray(fes.mesh.vertices), device="cuda")
    rng = np.random.default_rng(1)
    v = torch.as_tensor(1e-4 * (1 + rng.random(fes.nscalar)), device="cuda")
    sols = [sm.solve(verts, v) for _ in range(5)]
    assert len({s.iters for s in sols}) == 1
    assert all(torch.equal(s.x, sols[0].x) for s in sols)
