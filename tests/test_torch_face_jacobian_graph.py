"""The SEB face Jacobians as a CUDA graph per key, and what the graph
needs: the boundary values of a ``BoundaryState`` taken as 0-d tensors by
``seb.py`` (the same numbers as the float path, bit for bit, on every flux
branch), the B' table's device cache (a lookup through it equals a fresh
table's, a second lookup adds no entry, and a pickled table carries none),
``seb_face_jacobians`` on the CPU (eager, counted, the blocks of the plain
``vmap(jacfwd)`` of ``seb_face_res_fn``) and the reader of
``face_jacobian_graph_replay_pct``.
On the card: a case-2.2 run with the face graph equals the same run with
the capture patched out; a replay after the boundary values and the mesh
moved equals the eager blocks at the new values; a branch of its own
captures a graph of its own; a replay waits for nothing; and the graphs
die with their system, with no collection.

torch alone (no JAX), on strips of ``torch_ablation_helpers`` with the
synthetic TACOT deck and B' table, float64."""

import pickle

import numpy as np
import pytest
import torch

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, TOP, case22_cfg, heating_fields, one_torch_thread, rel,
    strip_file)

BRANCHES = ["chemistry_blowing", "chemistry_no_blowing", "cooling_standard",
            "cooling_exact"]
CASES = [(3, 30, 1), (2, 12, 2)]
VALUES = ("p_w", "rhoeUeCH", "h_r", "hconv", "Tedge")
KINDS = ("face_jacobian_eager", "face_jacobian_captures",
         "face_jacobian_replays")


def _bc_model(branch, rhoeUeCH=0.3, p_w=101325.0, h_r=1.5e6, case22=True):
    """The boundary state and the flux model of one branch: the schedule's
    heating state with chemistry on, its cooling state off."""
    from cmfem_tpu_torch.physics import seb, surface_bc

    kw = {"pato_compat_mode": "cooling_exact"} \
        if branch == "cooling_exact" else {}
    chem = int(branch.startswith("chemistry"))
    rh = 0.0 if branch == "chemistry_no_blowing" else rhoeUeCH
    model = seb.SurfaceFluxModel(case22=case22, **kw)
    bc = surface_bc.BoundaryState(p_w, rh, h_r, 10.0, 300.0, True, True,
                                  chem)
    assert seb.classify_branch(bc, model) == branch
    return bc, model


def _as_tensors(bc, like):
    """``bc`` with its boundary values as 0-d tensors of ``like``."""
    import dataclasses

    return dataclasses.replace(bc, **{
        k: torch.full((), float(getattr(bc, k)), dtype=like.dtype,
                      device=like.device) for k in VALUES})


def _flux_inputs(n=24, seed=3):
    """Wall mass fluxes (outflow, inflow and an exact 0), gas enthalpies
    and wall temperatures across the B' table's range."""
    g = np.random.default_rng(seed)
    m = g.uniform(-0.05, 0.4, n)
    m[0] = 0.0
    T = g.uniform(400.0, 3900.0, n)
    h = g.uniform(-1e6, 4e6, n)
    return tuple(torch.tensor(a) for a in (m, h, T))


def _same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case22", [False, True])
@pytest.mark.parametrize("branch", BRANCHES)
def test_surface_flux_takes_device_scalars_bit_for_bit(branch, case22):
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.physics.seb import surface_flux

    bc, model = _bc_model(branch, case22=case22)
    table = BPrimeTable.synthetic_tacot()
    m, h, T = _flux_inputs()
    eps, alpha, refl = 0.8 + 0 * T, 0.7 + 0 * T, 0.1 + 0 * T

    def q(bc_):
        return lambda m_, T_: surface_flux(m_, h, T_, eps, alpha, refl, bc_,
                                           branch, model, table)

    tbc = _as_tensors(bc, T)
    a, b = q(bc)(m, T), q(tbc)(m, T)
    assert set(a) == set(b)
    for k in a:
        assert _same(a[k], b[k]), k
    jac = lambda bc_: torch.func.jacfwd(lambda m_, T_: q(bc_)(m_, T_)
                                        ["q_surf"], argnums=(0, 1))(m, T)
    for ja, jb in zip(jac(bc), jac(tbc)):
        assert _same(ja, jb)
    assert float(a["q_surf"].abs().max()) > 0.0


@pytest.mark.parametrize("branch", BRANCHES)
def test_fixed_points_take_device_scalars_bit_for_bit(branch):
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.physics.seb import solve_blowing, solve_blowing_22

    bc, model = _bc_model(branch)
    table = BPrimeTable.synthetic_tacot()
    m, _, T = _flux_inputs(seed=5)
    tbc = _as_tensors(bc, T)
    chem = bc.chemistryOn != 0
    enable = branch == "chemistry_blowing"
    for f in (lambda m_, b: solve_blowing_22(m_, b.rhoeUeCH, b.p_w, T, table,
                                             chem, False, model.lam, enable),
              lambda m_, b: solve_blowing(m_, b.rhoeUeCH, model.lam,
                                          enable)):
        for x, y in zip(f(m, bc), f(m, tbc)):
            assert _same(x, y)
        for x, y in zip(torch.func.jacfwd(lambda m_: f(m_, bc))(m),
                        torch.func.jacfwd(lambda m_: f(m_, tbc))(m)):
            assert _same(x, y)


def _ragged_table():
    """A B' table whose (p, B'g) levels each have T knots of their own."""
    from cmfem_tpu_torch.physics.bprime import BPrimeTable

    rows = []
    for i, p in enumerate([1013.25, 101325.0]):
        for j, bg in enumerate([1e-3, 1e-1, 10.0]):
            Ts = np.linspace(250.0 + 10 * j, 3800.0 - 40 * i, 30 + 3 * i + j)
            bc = 0.17 / (1.0 + bg) / (1.0 + np.exp(-(Ts - 1200.0) / 80.0))
            hw = 1.1e3 * (Ts - 298.0) - 4.0e5 * bg / (1.0 + bg) + 50.0 * i
            rows += [(p, bg, c, t, w) for c, t, w in zip(bc, Ts, hw)]
    p, bg, bc, T, hw = map(np.array, zip(*rows))
    table = BPrimeTable.from_rows(p, bg, bc, T, hw)
    assert not table.uniform
    return lambda: BPrimeTable.from_rows(p, bg, bc, T, hw)


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_lookup_through_the_device_cache_equals_a_fresh_table(kind):
    from cmfem_tpu_torch.physics.bprime import BPrimeTable

    make = BPrimeTable.synthetic_tacot if kind == "uniform" \
        else _ragged_table()
    g = np.random.default_rng(11)
    n = 40
    # inside and outside every axis: the clamps and their flags too
    q = [torch.tensor(a) for a in (g.uniform(500.0, 2e5, n),
                                   10 ** g.uniform(-5.0, 1.5, n),
                                   g.uniform(100.0, 4200.0, n))]
    warm = make()
    first = warm.lookup(*q)
    entries = dict(warm._dev._c)
    assert entries
    second = warm.lookup(*q)
    assert warm._dev._c.keys() == entries.keys()
    assert all(warm._dev._c[k] is v for k, v in entries.items())
    fresh = make().lookup(*q)
    # a pickled table (a rank's result sent to its parent) carries no cache
    copy = pickle.loads(pickle.dumps(warm))
    assert copy._dev._c == {}
    again = copy.lookup(*q)
    for k in first:
        assert _same(first[k], fresh[k]) and _same(second[k], fresh[k]), k
        assert _same(again[k], fresh[k]), k
    assert any(bool(fresh[k].any()) for k in
               ("clamped_p", "clamped_bg", "clamped_t"))


def _system(tmpdir, nx, ny, order, device):
    """The port's AblationSystem on a strip, a hot wall with the gas
    flowing out of the top, and the extents after a long step of a cooler
    field (both reactions under way near the top)."""
    from cmfem_tpu_torch.core import FESpace, load_gmsh
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import (AblationState,
                                                  AblationSystem)
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    fes = FESpace(load_gmsh(strip_file(tmpdir, nx, ny)), order)
    sys_ = AblationSystem(
        SpaceOps(fes, quad_order=max(2, 2 * order + 2), device=device),
        TacotMaterial.load_yaml(FIXTURE), gravity=(0.0, -9.81), top_attr=TOP)
    xy = np.asarray(fes.node_positions)
    t = lambda a: torch.tensor(a, device=device)
    To, po = map(t, heating_fields(xy, hot=0.7, gas=0.0))
    T = t(heating_fields(xy)[0])
    p = t(2.0e4 + 4.0e5 * (0.05 - xy[:, 1]))
    state = sys_.advance_state(
        AblationState.initial(sys_.ne, sys_.nq, sys_.mat, device=device),
        To, po, 1.0)
    return sys_, T, p, state.extent


def _plain_blocks(sys_, T, p, extent, bc, branch, model, bprime,
                  vertices=None):
    """The face blocks as one plain ``vmap(jacfwd)`` of
    ``seb_face_res_fn`` with ``bc``'s float values."""
    tr = sys_.trace
    ff = tr.face_factors(vertices)
    face_res = sys_.seb_face_res_fn(bc, branch, model, bprime)
    return torch.func.vmap(torch.func.jacfwd(face_res, argnums=(0, 1)))(
        T[tr.eldofs], p[tr.eldofs], tr.Btab[tr._combo_t],
        tr.Gtab[tr._combo_t], tr.element_invJ(vertices), ff.normal, ff.wdS,
        extent[sys_._trace_elem, 0])


@pytest.fixture(scope="module", params=CASES, ids=["3x30_p1", "2x12_p2"])
def cpu_system(request, tmp_path_factory):
    nx, ny, order = request.param
    return _system(tmp_path_factory.mktemp("strip"), nx, ny, order, "cpu")


@pytest.mark.parametrize("branch", BRANCHES)
def test_cpu_face_jacobians_are_eager_and_counted(cpu_system, branch):
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.utils.timing import StepTimer

    sys_, T, p, X = cpu_system
    bc, model = _bc_model(branch)
    table = BPrimeTable.synthetic_tacot()
    timer = StepTimer()
    with timer.span("call"):
        blocks = sys_.seb_face_jacobians(T, p, X, bc, branch, model, table)
    assert {k: v for k, v in timer.counts.items()
            if k.startswith("face_jacobian_")} == {"face_jacobian_eager": 1}
    assert sys_._graphs == {}
    plain = _plain_blocks(sys_, T, p, X, bc, branch, model, table)
    # (cooling_standard's flux does not depend on p: its p block is 0)
    assert float(plain[0].abs().max()) > 0.0
    for a, b in zip(plain, blocks):
        assert a.shape == b.shape and rel(a.numpy(), b) <= 1e-12


def _reader():
    from bench_port import harness

    return harness.load_module("metrics", "face_jacobian_graph_replay_pct")


def test_replay_share_reader_on_synthetic_rows():
    read = _reader().read
    rows = [{"face_jacobian": 0.9, "face_jacobian_eager": 1,
             "face_jacobian_captures": 1, "face_jacobian_replays": 1},
            {"face_jacobian": 0.1, "face_jacobian_replays": 3},
            {"face_jacobian": 0.1, "jacobian_replays": 3,
             "face_jacobian_replays": 3}]
    assert read({"timing_rows": rows}) == pytest.approx(100.0 * 7 / 9)
    assert read({"timing_rows": rows[:1]}) == pytest.approx(100.0 / 3)
    assert read({"timing_rows": [{"face_jacobian_eager": 3}]}) == 0.0
    # the parent's rows: no counter of the face graph
    old = [{k: v for k, v in r.items() if k not in KINDS} for r in rows]
    assert read({"timing_rows": old}) is None
    assert read({"timing_rows": []}) is None
    assert read({"unit": "apply", "attempted": 10}) is None


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(sys_, timer, *args, **kw):
    with timer.span("call"):
        out = sys_.seb_face_jacobians(*args, **kw)
    return out, {k: v for k, v in timer.step_reset().items()
                 if k.startswith("face_jacobian_")}


def _moved_vertices(sys_, device, steps):
    """The strip's vertices after each of ``steps`` moves of a
    ``MeshRecessionHandler`` (a top receding at 1–2 mm/s, faster in the
    middle), as device tensors."""
    from cmfem_tpu_torch.motion.recession import MeshRecessionHandler

    fes = sys_.ops.fes
    h = MeshRecessionHandler(fes.mesh, fes, bdr_attr_top=TOP,
                             bdr_attr_bottom=1, device=device)
    x = np.asarray(fes.node_positions)[:, 0]
    v = 1e-3 * (1.0 + np.sin(np.pi * x / x.max()))
    out = []
    for _ in range(steps):
        h.prepare_advance(v, 0.1)
        h.commit_advance()
        out.append(torch.tensor(h.vertices, device=device))
    assert h.total_recession > 0.0
    return out


@pytest.mark.gpu
def test_replay_after_the_boundary_values_change_equals_eager(tmp_path):
    """Calls at ρₑuₑC_H 0.1, then 0.3 with p_w and h_r 2% up and down, each
    on a mesh the handler moved: an eager call, a capture and a replay, each
    equal to the plain blocks at its values to 1e-12 of the largest entry;
    the capture's blocks stay its own after the replay."""
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.utils.timing import StepTimer

    dev = _cuda()
    sys_, T, p, X = _system(tmp_path, 3, 30, 1, dev)
    table = BPrimeTable.synthetic_tacot()
    branch = "chemistry_blowing"
    verts = _moved_vertices(sys_, dev, 3)
    calls = [_bc_model(branch, rhoeUeCH=0.1),
             _bc_model(branch, 0.3, 101325.0 * 1.02, 1.5e6 * 0.98),
             _bc_model(branch, 0.3, 101325.0 * 0.98, 1.5e6 * 1.02)]
    timer = StepTimer()
    seen, outs, refs = [], [], []
    for (bc, model), v in zip(calls, verts):
        out, kinds = _counted(sys_, timer, T, p, X, bc, branch, model, table,
                              vertices=v)
        seen.append(kinds)
        outs.append(out)
        refs.append(_plain_blocks(sys_, T, p, X, bc, branch, model, table,
                                  vertices=v))
    assert seen == [{"face_jacobian_eager": 1},
                    {"face_jacobian_captures": 1},
                    {"face_jacobian_replays": 1}]
    for out, ref in zip(outs, refs):
        for a, b in zip(ref, out):
            assert b.is_cuda and rel(a.cpu().numpy(), b) <= 1e-12
    # the values and the mesh reached the graph: the blocks moved
    assert max(rel(a.cpu().numpy(), b) for a, b in zip(refs[1], refs[2])) \
        > 1e-3


@pytest.mark.gpu
def test_a_branch_captures_a_graph_of_its_own(tmp_path):
    from cmfem_tpu_torch.physics.bprime import BPrimeTable
    from cmfem_tpu_torch.utils.timing import StepTimer

    dev = _cuda()
    sys_, T, p, X = _system(tmp_path, 3, 30, 1, dev)
    table = BPrimeTable.synthetic_tacot()
    order = ["chemistry_blowing", "chemistry_blowing", "chemistry_no_blowing",
             "chemistry_no_blowing", "chemistry_blowing",
             "chemistry_no_blowing"]
    timer = StepTimer()
    seen = []
    for branch in order:
        bc, model = _bc_model(branch)
        out, kinds = _counted(sys_, timer, T, p, X, bc, branch, model, table)
        seen.append(kinds)
        for a, b in zip(_plain_blocks(sys_, T, p, X, bc, branch, model,
                                      table), out):
            assert rel(a.cpu().numpy(), b) <= 1e-12
    assert seen == [{"face_jacobian_" + k: 1} for k in
                    ("eager", "captures", "eager", "captures", "replays",
                     "replays")]
    assert sum(g is not None for g in sys_._graphs.values()) == 2


@pytest.mark.gpu
def test_a_replay_waits_for_nothing(tmp_path):
    """A replay at new boundary values on a moved mesh under
    ``torch.cuda.set_sync_debug_mode("error")``: no copy from the host and
    no read-back in the call."""
    from cmfem_tpu_torch.physics.bprime import BPrimeTable

    dev = _cuda()
    sys_, T, p, X = _system(tmp_path, 3, 30, 1, dev)
    table = BPrimeTable.synthetic_tacot()
    branch = "chemistry_blowing"
    v0, v1 = _moved_vertices(sys_, dev, 2)
    bc, model = _bc_model(branch, 0.1)
    for _ in range(2):          # the eager call and the capture
        sys_.seb_face_jacobians(T, p, X, bc, branch, model, table,
                                vertices=v0)
    bc2, _ = _bc_model(branch, 0.25, 101325.0 * 1.01, 1.5e6 * 0.99)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sys_.seb_face_jacobians(T, p, X, bc2, branch, model, table,
                                      vertices=v1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(_plain_blocks(sys_, T, p, X, bc2, branch, model, table,
                                  vertices=v1), out):
        assert rel(a.cpu().numpy(), b) <= 1e-12


@pytest.mark.gpu
def test_graphs_are_freed_with_their_system(tmp_path):
    """With the garbage collector off, a system's element and face graphs
    die with its last reference: none refers back to the system, so none
    waits for a collection, which may fall inside the next run's capture."""
    import gc
    import weakref

    from cmfem_tpu_torch.physics.bprime import BPrimeTable

    dev = _cuda()
    sys_, T, p, X = _system(tmp_path, 3, 30, 1, dev)
    table = BPrimeTable.synthetic_tacot()
    branch = "chemistry_blowing"
    bc, model = _bc_model(branch)
    Tq, pq = sys_.ops.values_at_qp(T), sys_.ops.values_at_qp(p)
    for _ in range(2):
        sys_.element_jacobians(T, p, Tq, pq, X, 0.1)
        sys_.seb_face_jacobians(T, p, X, bc, branch, model, table)
    graphs = [weakref.ref(g) for g in sys_._graphs.values()]
    assert len(graphs) == 2 and all(g() is not None for g in graphs)
    gc.disable()
    try:
        del sys_
        assert all(g() is None for g in graphs)
    finally:
        gc.enable()


@pytest.mark.gpu
def test_graph_run_equals_run_with_eager_faces(tmp_path, monkeypatch):
    """A 3-step case-2.2 run on the card, its face Jacobians replayed from a
    CUDA graph after the key's eager call and capture, against the same run
    with the face capture patched out: the same Newton counts, T and p
    within 1e-10 of their largest values, the vertices and the recession
    within the cell's limits (1e-11 m, 3e-6 relative); the rows count the
    calls by kind and the reader reads their share."""
    from cmfem_tpu_torch.apps import ablation_case2_2 as P
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    _cuda()
    strip = strip_file(tmp_path, 3, 20)
    cfg = lambda out: case22_cfg(strip, tmp_path / out, t_final=0.3,
                                 linear_solver="lu")
    graph = P.run(cfg("graph"), device="cuda")
    monkeypatch.setattr(AblationSystem, "_capture_face_jacobians",
                        lambda self, *args: None)
    eager = P.run(cfg("eager"), device="cuda")
    assert graph["newton_iters"] == eager["newton_iters"]
    for k in ("T", "p"):
        assert np.abs(graph[k] - eager[k]).max() <= \
            1e-10 * np.abs(eager[k]).max()
    assert np.abs(graph["vertices"] - eager["vertices"]).max() <= 1e-11
    assert eager["recession_total"] > 0.0
    assert graph["recession_total"] == pytest.approx(
        eager["recession_total"], rel=3e-6)
    calls = lambda out, k: sum(r.get(k, 0) for r in out["timing"])
    assert [calls(graph, k) for k in KINDS[:2]] == [1, 1]
    replays = calls(graph, "face_jacobian_replays")
    assert replays >= 1
    assert calls(eager, "face_jacobian_captures") == 0 == \
        calls(eager, "face_jacobian_replays")
    read = _reader().read
    assert read({"timing_rows": graph["timing"]}) == \
        pytest.approx(100.0 * replays / (replays + 2))
    assert read({"timing_rows": eager["timing"]}) == 0.0
