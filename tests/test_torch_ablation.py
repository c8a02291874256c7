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
SEB terms are held in ``test_torch_ablation_seb.py``).  On the card the
element Jacobians' CUDA graph (eager, captured, replayed) is held to the
eager ``vmap(jacfwd)`` on the 11 x 239 strip, the port alone."""

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, TOP, ablation_pair, heating_fields, one_torch_thread, rel,
    strip_file)

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


def _strip_system(tmpdir, device, nx=11, ny=239):
    """The port's AblationSystem alone (no JAX) on the graded strip, a
    heated (T, p) and the extents after a long step of the cooler field
    (both reactions under way near the top): the element Jacobians'
    arguments but ``dt``."""
    from cmfem_tpu_torch.core import FESpace, load_gmsh
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import (AblationState,
                                                  AblationSystem)
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    fes = FESpace(load_gmsh(strip_file(tmpdir, nx, ny)), 1)
    sys_ = AblationSystem(SpaceOps(fes, quad_order=4, device=device),
                          TacotMaterial.load_yaml(FIXTURE),
                          gravity=(0.0, -9.81), top_attr=TOP)
    xy = np.asarray(fes.node_positions)
    t = lambda a: torch.tensor(a, device=device)
    To, po = map(t, heating_fields(xy, hot=0.7, gas=0.0))
    T, p = map(t, heating_fields(xy))
    state = sys_.advance_state(
        AblationState.initial(sys_.ne, sys_.nq, sys_.mat, device=device),
        To, po, 1.0)
    return sys_, (T, p, sys_.ops.values_at_qp(To),
                  sys_.ops.values_at_qp(po), state.extent)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["case1", "case22"])
def test_cuda_graph_jacobians_equal_eager(tmp_path, case):
    """``element_jacobians``' first (eager), second (captured and replayed)
    and third (replayed at another T and dt) calls on the card, each
    against the eager ``vmap(jacfwd)`` at its arguments to 1e-12 of the
    block's largest entry; the second call's blocks are still its own after
    the third.  "case22" passes case 2.2's arguments, a new geometry each
    call (``gf``), a mesh velocity ``wq``, a GCL pair and ``ale_toggles``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.core import GeometricFactors
    from cmfem_tpu_torch.utils.timing import StepTimer

    dev = torch.device("cuda")
    sys_, args = _strip_system(tmp_path, dev)
    assert 0.05 < float(args[4].max()) < 1.0
    gen = torch.Generator().manual_seed(7)
    noise = lambda a: (1e-3 * torch.randn(a.shape, generator=gen,
                                          dtype=a.dtype)).to(dev)

    def case_kw(call):
        if case == "case1":
            return {}
        gf, s = sys_.ops.gf, 1.0 + 1e-3 * (call + 1)
        return {"gf": GeometricFactors(gf.detJ * s, gf.invJ / s,
                                       gf.wdetJ * s, gf.xq),
                "wq": noise(gf.xq), "gcl": (gf.detJ * (1.0 + noise(gf.detJ)),
                                            gf.detJ * s),
                "ale_toggles": (True, False, True)}

    timer = StepTimer()
    seen, outs, refs = [], [], []
    for call, (dT, dt) in enumerate([(0.0, 0.1), (0.0, 0.1), (7.5, 0.0731)]):
        kw = case_kw(call)
        T = args[0] + dT
        with timer.span("call"):
            outs.append(sys_.element_jacobians(T, *args[1:], dt, **kw))
        seen.append({k: v for k, v in timer.step_reset().items()
                     if k.startswith("jacobian_")})
        gf = kw.get("gf", sys_.ops.gf)
        refs.append(sys_._element_jacobians(
            T, args[1], gf.invJ, gf.wdetJ, *args[2:], kw.get("wq"),
            kw.get("gcl"), dt, kw.get("ale_toggles", (True, True, True))))
    assert seen == [{"jacobian_eager": 1}, {"jacobian_captures": 1},
                    {"jacobian_replays": 1}]
    for out, ref in zip(outs, refs):
        for a, b in zip(ref, out):
            scale = float(a.abs().max())
            assert scale > 0.0 and float((a - b).abs().max()) <= 1e-12 * scale
    # the third call's inputs reached the graph: its blocks moved
    assert max(float((a - b).abs().max() / a.abs().max())
               for a, b in zip(refs[1], refs[2])) > 1e-3
