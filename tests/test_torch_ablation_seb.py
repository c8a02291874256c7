"""Port parity, the SEB (surface-energy-balance) part of
``physics/ablation.py``: both packages' ``AblationSystem`` on the 3 x 30
order-1 and 2 x 12 order-2 strips of ``torch_ablation_helpers``, with the
synthetic TACOT deck and B' table, at a state whose gas flows out of the
heated top (B'g inside the table on the blowing branch), float64 on the
CPU.  On every flux branch the face residual agrees to 1e-12, the
``vmap(jacfwd)`` face Jacobian blocks to 1e-10 and the area-averaged
boundary terms to 1e-12 (relative to the largest entry).
``jacobian_check`` with ``seb`` passes on each branch from a state whose
blowing fixed point lies inside the table, returns None where the JAX
package skips (a B' clamp with chemistry on), and raises on a face
Jacobian scaled by 1.1."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    TOP, ablation_pair, rel, one_torch_thread)

CASES = [(3, 30, 1), (2, 12, 2)]
BRANCHES = ["chemistry_blowing", "chemistry_no_blowing", "cooling_standard",
            "cooling_exact"]


@pytest.fixture(scope="module", params=CASES, ids=["3x30_p1", "2x12_p2"])
def pair(request, tmp_path_factory):
    nx, ny, order = request.param
    return ablation_pair(tmp_path_factory.mktemp("strip"), nx, ny, order)


def _flux_setup(branch):
    """(JAX model, bc, table), (port model, bc, table) for one branch: the
    schedule's heating state with chemistry on, its cooling state off."""
    from cmfem_tpu.physics import bprime as JB, seb as JS, surface_bc as JBC
    from cmfem_tpu_torch.physics import bprime as PB, seb as PS, \
        surface_bc as PBC

    kw = {"pato_compat_mode": "cooling_exact"} \
        if branch == "cooling_exact" else {}
    chem = int(branch.startswith("chemistry"))
    rh = 0.0 if branch == "chemistry_no_blowing" else 0.3
    args = (101325.0, rh, 1.5e6, 10.0, 300.0, True, True, chem)
    out = []
    for S, BC, B in ((JS, JBC, JB), (PS, PBC, PB)):
        model, bc = S.SurfaceFluxModel(**kw), BC.BoundaryState(*args)
        assert S.classify_branch(bc, model) == branch
        out.append((model, bc, B.BPrimeTable.synthetic_tacot()))
    return out


def _outflow_fields(pair):
    """The pair's hot wall with a pressure that falls toward the top: the
    pyrolysis gas leaves through the heated face."""
    xy = np.asarray(pair["fes"].node_positions)
    return pair["T"], 2.0e4 + 4.0e5 * (0.05 - xy[:, 1])


@pytest.mark.parametrize("branch", BRANCHES)
def test_seb_face_terms_match_jax(pair, branch):
    import jax
    import jax.numpy as jnp

    (jm, jbc, jb), (pm, pbc, pb) = _flux_setup(branch)
    jsys, psys = pair["jsys"], pair["psys"]
    T, p = _outflow_fields(pair)
    jX = jnp.asarray(pair["jstate"].extent)
    jT, jp = jnp.asarray(T), jnp.asarray(p)
    pargs = (torch.tensor(T), torch.tensor(p), pair["state"].extent)
    # the JAX side jitted: its eager transforms dispatch op by op
    rj = jax.jit(lambda T, p: jsys.seb_face_residual(
        T, p, jX, jbc, branch, jm, jb))(jT, jp)
    rp = psys.seb_face_residual(*pargs, pbc, branch, pm, pb)
    assert rel(rj, rp) < 1e-12 and np.abs(np.asarray(rj)).max() > 1.0
    Jj = jax.jit(lambda T, p: jsys.seb_face_jacobians(
        T, p, jX, jbc, branch, jm, jb))(jT, jp)
    for a, b in zip(Jj, psys.seb_face_jacobians(*pargs, pbc, branch, pm,
                                                pb)):
        assert tuple(b.shape) == a.shape and rel(a, b) < 1e-10
    tj = jsys.top_boundary_terms(jT, jp, jX[jsys.trace.elem, 0], jbc,
                                 branch, jm, jb)
    tp = psys.top_boundary_terms(*pargs[:2],
                                 pargs[2][psys._trace_elem, 0], pbc, branch,
                                 pm, pb)
    assert set(tp) == set(tj)
    for k in tj:
        a, b = float(tj[k]), float(tp[k])
        assert abs(a - b) <= 1e-12 * abs(a), (k, a, b)
    if branch == "chemistry_blowing":      # B'g inside the table
        assert 1e-4 < float(tp["BprimeG_surf"]) < 10.0
        assert float(tp["clamps_bg"]) == 0.0 < float(tp["m_dot_g_surf"])
    # the diagnostics: the same values as host floats, one read-back, and
    # the clamp counts added to the table's statistics
    diag = psys.top_boundary_diagnostics(*pargs[:2], pair["state"], pbc,
                                         branch, pm, pb)
    assert set(diag) == {"m_dot_g_surf"} | set(psys._SURF_KEYS)
    assert all(diag[k] == float(tp[k]) for k in diag)
    assert [pb.clamp_stats.p, pb.clamp_stats.bg, pb.clamp_stats.t] == \
        [int(tj[k]) for k in ("clamps_p", "clamps_bg", "clamps_t")]


def _check_state(tmpdir):
    """The JAX test's jacobian_check state on the 3 x 30 strip: T 600 K with
    the top at 1100 K, p falling linearly toward the top (outflow), the
    initial extents, dt 0.05."""
    from cmfem_tpu_torch.core import FESpace, load_gmsh
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import AblationState, AblationSystem
    from cmfem_tpu_torch.physics.tacot import TacotMaterial
    from torch_ablation_helpers import FIXTURE, strip_file

    fes = FESpace(load_gmsh(strip_file(tmpdir, 3, 30)), 1)
    sys_ = AblationSystem(SpaceOps(fes, quad_order=4, device="cpu"),
                          TacotMaterial.load_yaml(FIXTURE), top_attr=TOP)
    n = fes.nscalar
    ess = torch.as_tensor(fes.boundary_dofs([TOP]))
    T = torch.full((n,), 600.0, dtype=torch.float64)
    T[ess] = 1100.0
    y = torch.as_tensor(np.asarray(fes.node_positions)[:, 1])
    p = 5.0e4 + 4.0e4 * (0.05 - y)
    st = AblationState.initial(sys_.ne, sys_.nq, sys_.mat, device="cpu")
    args = (T, p, sys_.ops.values_at_qp(torch.full((n,), 600.0,
                                                   dtype=torch.float64)),
            sys_.ops.values_at_qp(p), st.extent, 0.05)
    return sys_, args


@pytest.fixture(scope="module")
def check_state(tmp_path_factory):
    return _check_state(tmp_path_factory.mktemp("check"))


def _seb(branch):
    from cmfem_tpu_torch.physics import bprime, seb, surface_bc

    mdl = seb.SurfaceFluxModel(
        lam=0.5, q_rad=0.0,
        pato_compat_mode="cooling_exact" if branch == "cooling_exact"
        else "off")
    chem = branch.startswith("chemistry")
    bc = surface_bc.BoundaryState(p_w=5.0e4, rhoeUeCH=0.01 if chem else 0.0,
                                  h_r=2.0e6 if chem else 0.0,
                                  chemistryOn=int(chem))
    return (branch, mdl, bprime.BPrimeTable.synthetic_tacot()), bc


@pytest.mark.parametrize("branch", BRANCHES)
def test_jacobian_check_with_seb_per_branch(check_state, branch):
    sys_, args = check_state
    seb, bc = _seb(branch)
    rel_err = sys_.jacobian_check(*args, abs_tol=1e-6, rel_tol=1e-4,
                                  seb=seb, bc=bc)
    if branch == "chemistry_no_blowing":
        # B'g = 0 lies below the table's lowest level: a clamp with
        # chemistry on, skipped as in the JAX package
        assert rel_err is None
    else:
        assert rel_err is not None and 0.0 <= rel_err < 1e-4
    if branch == "chemistry_blowing":
        terms = sys_.top_boundary_terms(args[0], args[1],
                                        args[4][sys_._trace_elem, 0], bc,
                                        *seb)
        assert 1e-4 < float(terms["BprimeG_surf"]) < 10.0


def test_jacobian_check_skips_where_jax_skips(tmp_path):
    """At a uniform pressure the wall mass flux is 0, so B'g = 0 lies below
    the table: with chemistry on both packages skip the check."""
    import jax.numpy as jnp
    from cmfem_tpu.core import FESpace as JF, load_gmsh as jload
    from cmfem_tpu.ops import SpaceOps as JOps
    from cmfem_tpu.physics import bprime as JB, seb as JS, surface_bc as JBC
    from cmfem_tpu.physics.ablation import AblationSystem as JSys
    from cmfem_tpu.physics.tacot import TacotMaterial as JMat
    from torch_ablation_helpers import FIXTURE, strip_file

    sys_, args = _check_state(tmp_path)
    n = sys_.n
    p = torch.full((n,), 5.0e4, dtype=torch.float64)
    pargs = (args[0], p, args[2], sys_.ops.values_at_qp(p)) + args[4:]
    for branch in ("chemistry_blowing", "chemistry_no_blowing"):
        seb, bc = _seb(branch)
        assert sys_.jacobian_check(*pargs, seb=seb, bc=bc) is None
    jsys = JSys(JOps(JF(jload(strip_file(tmp_path, 3, 30)), 1),
                     quad_order=4), JMat.load_yaml(FIXTURE), top_attr=TOP)
    jT, jp = jnp.asarray(args[0].numpy()), jnp.asarray(p.numpy())
    jbc = JBC.BoundaryState(p_w=5.0e4, rhoeUeCH=0.01, h_r=2.0e6,
                            chemistryOn=1)
    assert jsys.jacobian_check(
        jT, jp, jsys.ops.values_at_qp(jnp.full(n, 600.0)),
        jsys.ops.values_at_qp(jp), jnp.asarray(args[4].numpy()), 0.05,
        seb=("chemistry_blowing", JS.SurfaceFluxModel(lam=0.5, q_rad=0.0),
             JB.BPrimeTable.synthetic_tacot()), bc=jbc) is None


def test_jacobian_check_catches_a_wrong_face_jacobian(check_state,
                                                      monkeypatch):
    sys_, args = check_state
    seb, bc = _seb("chemistry_blowing")
    assert sys_.jacobian_check(*args, seb=seb, bc=bc) is not None
    orig = sys_.seb_face_jacobians

    def scaled(*a, **k):
        JT, Jp = orig(*a, **k)
        return 1.1 * JT, Jp

    monkeypatch.setattr(sys_, "seb_face_jacobians", scaled)
    with pytest.raises(RuntimeError, match="Jacobian check failed"):
        sys_.jacobian_check(*args, seb=seb, bc=bc)


def test_top_boundary_diagnostics_nan_without_area(check_state):
    sys_, args = check_state
    seb, bc = _seb("chemistry_blowing")
    vals = np.zeros(len(sys_.BOUNDARY_VALUE_KEYS))
    diag = sys_.boundary_diagnostics_from_values(vals, seb[2])
    assert len(diag) == 15 and all(np.isnan(v) for v in diag.values())
    diag = sys_.top_boundary_diagnostics(args[0], args[1],
                                         SimpleNamespace(extent=args[4]),
                                         bc, *seb,
                                         compute_surface_terms=False)
    assert np.isfinite(diag["m_dot_g_surf"])
    assert all(np.isnan(v) for k, v in diag.items() if k != "m_dot_g_surf")


@pytest.mark.gpu
def test_cuda_seb_face_jacobians_equal_cpu(check_state):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    sys_, args = check_state
    dev = torch.device("cuda")
    gsys = AblationSystem(SpaceOps(sys_.ops.fes, quad_order=4, device=dev),
                          sys_.mat, top_attr=TOP)
    gargs = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    for branch in BRANCHES:
        seb, bc = _seb(branch)
        for a, b in zip(sys_.seb_face_jacobians(args[0], args[1], args[4],
                                                bc, *seb),
                        gsys.seb_face_jacobians(gargs[0], gargs[1], gargs[4],
                                                bc, *seb)):
            assert b.is_cuda and rel(a.numpy(), b) < 1e-12
        a = sys_.seb_face_residual(args[0], args[1], args[4], bc, *seb)
        b = gsys.seb_face_residual(gargs[0], gargs[1], gargs[4], bc, *seb)
        assert rel(a.numpy(), b) < 1e-12
