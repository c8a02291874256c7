"""Port parity, the case-1 surface of ``physics/ablation.py``: both packages'
``AblationSystem`` on one strip (3 x 30 order-1 and 2 x 12 order-2 quads,
graded toward the heated top, gravity on), the synthetic TACOT deck and a
mid-heating state carried from the JAX package with
``ablation_state_from_numpy`` (and the JAX geometric factors for the
residual and the Jacobians), float64 on the CPU.  The residual to 1e-12,
the AD element Jacobians to 1e-10, the state advance and the top-boundary
mass flux to 1e-12 (relative to the largest entry); the lattice residual
equals the generic one to 1e-13; ``jacobian_check`` passes; the case-2.2
recession velocity and host mass-equation probes match JAX's (the case-2.1
SEB terms are held in ``test_torch_ablation_seb.py``)."""

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    ablation_pair, rel, one_torch_thread)

CASES = [(3, 30, 1), (2, 12, 2)]


@pytest.fixture(scope="module", params=CASES, ids=["3x30_p1", "2x12_p2"])
def pair(request, tmp_path_factory):
    nx, ny, order = request.param
    return ablation_pair(tmp_path_factory.mktemp("strip"), nx, ny, order)


def test_residual_matches_jax(pair):
    RTj, Rpj = pair["jsys"].residual(*pair["jargs"])
    RTp, Rpp = pair["psys"].residual(*pair["pargs"], gf=pair["gf"])
    assert rel(RTj, RTp) < 1e-12 and rel(Rpj, Rpp) < 1e-12
    assert np.abs(np.asarray(RTj)).max() > 1.0       # a real, nonzero state


def test_element_jacobians_match_jax(pair):
    bj = pair["jsys"].element_jacobians(*pair["jargs"])
    bp = pair["psys"].element_jacobians(*pair["pargs"], gf=pair["gf"])
    for a, b in zip(bj, bp):
        assert tuple(b.shape) == a.shape and rel(a, b) < 1e-10


def test_advance_state_matches_jax(pair):
    jst = pair["jsys"].advance_state(pair["jstate"], *pair["jargs"][:2], 0.1)
    pst = pair["psys"].advance_state(pair["state"], *pair["pargs"][:2], 0.1)
    for k in ("extent", "tau_elem", "rho_elem", "pi_elem", "mdot_elem",
              "extent_elem", "degree_char_elem",
              "char_density_fraction_elem", "pi_qp"):
        a, b = np.asarray(getattr(jst, k)), getattr(pst, k)
        assert rel(a, b) < 1e-12 or np.abs(a).max() == 0.0 == \
            np.abs(np.asarray(b)).max(), k
    assert np.asarray(jst.pi_elem).max() > 0.0       # pyrolysis under way


def test_top_boundary_mass_flux_matches_jax(pair):
    T, p = pair["jargs"][:2]
    for st_j, st_p in ((pair["jstate"], pair["state"]),
                       (pair["jstate"].extent, pair["state"].extent)):
        a = float(pair["jsys"].top_boundary_mass_flux(T, p, st_j))
        b = float(pair["psys"].top_boundary_mass_flux(*pair["pargs"][:2],
                                                      st_p))
        assert abs(a - b) <= 1e-12 * abs(a) and a != 0.0


def test_lattice_residual_equals_generic(pair):
    from cmfem_tpu_torch.solvers.blocksolve import strip_dof_lattice

    psys = pair["psys"]
    ref = psys.residual(*pair["pargs"])
    psys.set_dof_lattice(strip_dof_lattice(pair["fes"].node_positions))
    try:
        out = psys.residual(*pair["pargs"])
    finally:
        psys.lat = None
    for a, b in zip(ref, out):
        assert rel(a.numpy(), b) < 1e-13


def test_jacobian_check_passes(pair):
    err = pair["psys"].jacobian_check(*pair["pargs"])
    assert 0.0 <= err < 1e-4


def test_case2_methods_raise(pair):
    """The case-2.2 methods no longer raise: the recession velocity and the
    host mass-equation probes run on this pair and match JAX's to 1e-12
    (held on a triangle strip with the device probes too in
    ``test_torch_ablation_ale.py``)."""
    import jax.numpy as jnp

    from cmfem_tpu.physics import bprime as JB, seb as JS, surface_bc as JBC
    from cmfem_tpu_torch.physics import bprime as PB, seb as PS, \
        surface_bc as PBC

    jsys, psys = pair["jsys"], pair["psys"]
    T, p = pair["T"], pair["p"]
    bcargs = (101325.0, 0.3, 1.5e6, 10.0, 300.0, True, True, 1)
    a = jsys.top_boundary_recession_velocity(
        jnp.asarray(T), jnp.asarray(p), pair["jstate"],
        JBC.BoundaryState(*bcargs), "chemistry_blowing",
        JS.SurfaceFluxModel(case22=True), JB.BPrimeTable.synthetic_tacot())
    b = psys.top_boundary_recession_velocity(
        torch.tensor(T), torch.tensor(p), pair["state"],
        PBC.BoundaryState(*bcargs), "chemistry_blowing",
        PS.SurfaceFluxModel(case22=True), PB.BPrimeTable.synthetic_tacot())
    assert torch.is_tensor(b) and rel(a, b) < 1e-12
    pts = np.array([[0.00125, 0.049], [0.002, 0.02], [0.00125, 0.06]])
    a = jsys.mass_eq_probe(jnp.asarray(T), jnp.asarray(p), pair["jstate"],
                           pts)
    b = psys.mass_eq_probe(torch.tensor(T), torch.tensor(p), pair["state"],
                           pts)
    assert np.isnan(b[2]).all() and np.isnan(a[2]).all()
    assert rel(a[:2], b[:2]) < 1e-12


@pytest.mark.gpu
def test_cuda_residual_and_jacobians_equal_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    dev = torch.device("cuda")
    cpu = pair["psys"]
    gsys = AblationSystem(SpaceOps(cpu.ops.fes, quad_order=cpu.ops.quad.order,
                                   device=dev), cpu.mat,
                          gravity=(0.0, -9.81), top_attr=3)
    args = tuple(a.to(dev) if torch.is_tensor(a) else a
                 for a in pair["pargs"])
    for a, b in zip(cpu.residual(*pair["pargs"]), gsys.residual(*args)):
        assert rel(a.numpy(), b) < 1e-12
    for a, b in zip(cpu.element_jacobians(*pair["pargs"]),
                    gsys.element_jacobians(*args)):
        assert rel(a.numpy(), b) < 1e-10
