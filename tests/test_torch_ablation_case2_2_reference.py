"""The plain case-2.2 reference of the port's benchmark
(``bench_port/reference/ablation_case2_2.py``: PyTorch, numpy and scipy,
nothing of the port) against the port's case-2.2 set-up and driver, in
float64 on a 3 x 20 quad strip, for two seeded decks (the run's rho_e u_e
C_H plateau and h_r drawn within 2% of the benchmark configuration's, and
seeded random states on a receded mesh):

- the SEB face residual, the lumped recession velocity and the extent
  remap (under a mesh velocity large enough to move donors), to 1e-10
  relative: the same arithmetic in another order, so roundoff;
- the mesh velocity, to the smoother's rtol: the port's CG stops at a
  residual of 1e-12 of its right-hand side, the reference solves directly;
- a 3-step run's T, p, extents, vertices and total recession, to the
  Newton tolerances stated beside each below;
- on the deck's 11 x 239 strip, the smoother against the direct solve: it
  runs to its rtol there, past the ~80 iterations where the CG's stall
  exits would stop it.

Run: ``python -m pytest tests/test_torch_ablation_case2_2_reference.py -q``
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_ablation_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

R = harness.load_module("reference", "ablation_case2_2")
with open(os.path.join(ROOT, "bench_port", "configs",
                       "ablation-tc22.json")) as _f:
    CONFIG = json.load(_f)
CPU = torch.device("cpu")
STEPS = 3
SEEDS = (11, 2**31 + 7)


def _write_rows(path, rows):
    with open(path, "w") as f:
        f.writelines(" ".join(repr(float(v)) for v in r) + "\n"
                     for r in rows)
    return path


class Deck:
    """One seeded deck: the strip, the files, the port's set-up, the
    reference and a random state."""

    def __init__(self, seed, tmp):
        from cmfem_tpu_torch.apps.ablation_case2_2 import Case22

        rng = np.random.default_rng(seed)
        sc = CONFIG["surface_schedule"]
        u = 2.0 * rng.random(2) - 1.0
        self.rows = R.schedule_rows(
            sc, sc["rheuch_plateau"] * (1 + 0.02 * u[0]),
            sc["h_r"] * (1 + 0.02 * u[1]))
        self.mesh = R.strip_mesh(3, 20)
        verts, quads, segs, attrs = self.mesh
        bprime = R.bprime_rows(CONFIG["bprime"])
        material = os.path.join(tmp, "material.json")
        with open(material, "w") as f:
            json.dump(CONFIG["material"], f)
        self.cfg = {
            "mesh_file": R.write_gmsh(os.path.join(tmp, "strip.msh"),
                                      *self.mesh),
            "material_file": material,
            "boundary_conditions_file": _write_rows(
                os.path.join(tmp, "schedule.dat"), self.rows),
            "bprime_table_file": _write_rows(
                os.path.join(tmp, "bprime.dat"), bprime),
            "order": 1, "dt": CONFIG["dt"], "t_final": STEPS * CONFIG["dt"],
            "bdr_attr_top": CONFIG["top_attribute"],
            "bdr_attr_bottom": CONFIG["bottom_attribute"],
            "probe_x": CONFIG["probe_x"], "newton_print_level": 0,
            "save_paraview": False, "output_every": STEPS,
            "output_path": os.path.join(tmp, "out"), "linear_solver": "lu",
            **CONFIG["driver_options"]}
        self.case = Case22(self.cfg, CPU, torch.float64)
        self.ref = R.Case22Reference(
            CONFIG["material"], verts, quads,
            segs[attrs == CONFIG["top_attribute"]],
            segs[attrs == CONFIG["bottom_attribute"]], bprime,
            CONFIG["surface_model"], CPU)
        # a heated, pressurised, part-charred state on a receded mesh
        y = verts[:, 1] / verts[:, 1].max()
        nv = len(verts)
        self.T = torch.tensor(300.0 + rng.uniform(600, 1100) * y ** 4
                              + 20.0 * rng.random(nv))
        self.p = torch.tensor(101325.0 + rng.uniform(1e3, 5e3) * (1 - y)
                              + 50.0 * rng.random(nv))
        self.X = torch.tensor(rng.random((len(quads), 9, 2)))
        self.V = torch.tensor(np.stack([verts[:, 0], verts[:, 1]
                                        - rng.uniform(1e-5, 1e-4) * y], 1))
        self.t = 0.1 * rng.integers(1, 10)


@pytest.fixture(scope="module", params=SEEDS)
def deck(request, tmp_path_factory):
    return Deck(request.param, str(tmp_path_factory.mktemp("tc22")))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_face_residual_velocity_and_remap_match(deck):
    c, ref = deck.case, deck.ref
    bc, branch = c.boundary(deck.t)
    bcr = R.boundary(deck.rows, deck.t)
    T, p, X, V = deck.T, deck.p, deck.X, deck.V
    r_port = c.sys.seb_face_residual(T, p, X, bc, *c.seb(branch), vertices=V)
    geo = ref.geometry(V)
    fT = torch.func.vmap(ref._face_res(bcr))(*ref._face_args(T, p, X, geo))
    r_ref = torch.zeros_like(r_port).index_add_(
        0, ref.quads[ref.face_elem_t].reshape(-1), fT.reshape(-1))
    assert rel(r_port, r_ref) < 1e-10

    state = dataclasses.replace(c.initial_state(), extent=X)
    v_port = c.sys.top_boundary_recession_velocity(
        T, p, state, bc, branch, c.model, c.bprime, vertices=V)
    v_ref = ref.recession_velocity(T, p, X, V, bcr)
    assert float(v_ref.max()) > 0
    assert rel(v_port, v_ref) < 1e-10

    # a mesh velocity of 3 mm/s moves donors across quadrature points
    from cmfem_tpu_torch.motion.remap import remap_extents_ale

    w = torch.zeros_like(V)
    w[:, 1] = -3e-3 * V[:, 1] / V[:, 1].max()
    wq = torch.einsum("qn,end->eqd", c.ops.B, w[c.ops.eldofs])
    X_port = remap_extents_ale(c.mesh, c.ops, X, wq, 0.1, V.numpy())
    X_ref = ref.remap(X, V, w, 0.1)
    assert (np.abs(X_port - X.numpy()) > 0).any()
    assert rel(X_port, X_ref) < 1e-10


def test_mesh_velocity_matches_to_the_smoothers_rtol(deck):
    from cmfem_tpu_torch.motion.recession import smoothing_rtol

    c, ref = deck.case, deck.ref
    bcr = R.boundary(deck.rows, deck.t)
    v = ref.recession_velocity(deck.T, deck.p, deck.X, deck.V, bcr)
    handler = c.make_handler()
    handler.vertices = deck.V.numpy().copy()
    handler.prepare_advance(v, 0.1)
    w_ref = ref.mesh_velocity(deck.V, v)
    # the CG leaves a residual of rtol |b|; on this strip the condition
    # number (~1e2) makes that at most 1e2 rtol of the velocity
    assert rel(handler.mesh_velocity[:, 1], w_ref) \
        < 100 * smoothing_rtol(torch.float64)
    assert np.all(handler.mesh_velocity[:, 0] == 0)


def test_three_step_run_matches(deck, monkeypatch):
    from cmfem_tpu_torch.apps import ablation_case2_2
    from cmfem_tpu_torch.motion.recession import MeshRecessionHandler
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    commit, advance = (MeshRecessionHandler.commit_advance,
                       AblationSystem.advance_state_arrays)
    moved, records = {}, []

    def commit_hook(h):
        out = commit(h)
        moved["at"] = (h.vertices.copy(), out["total_recession"])
        return out

    def advance_hook(s, X_old, T, p, dt):
        out = advance(s, X_old, T, p, dt)
        records.append((T.clone(), p.clone(), float(dt), out[0].clone())
                       + moved.pop("at"))
        return out

    monkeypatch.setattr(MeshRecessionHandler, "commit_advance", commit_hook)
    monkeypatch.setattr(AblationSystem, "advance_state_arrays", advance_hook)
    out = ablation_case2_2.run(deck.cfg, device="cpu")
    assert len(records) == STEPS and all(out["moved"])

    ref = deck.ref
    verts = deck.mesh[0]
    nv = len(verts)
    T = torch.full((nv,), 300.0, dtype=torch.float64)
    p = torch.full((nv,), R.boundary(deck.rows, 0.0)["p_w"],
                   dtype=torch.float64)
    X = torch.zeros((len(deck.mesh[1]), 9, 2), dtype=torch.float64)
    V, total, t = torch.tensor(verts), 0.0, 0.0
    for T_p, p_p, dt, X_p, V_p, total_p in records:
        t = min(STEPS * CONFIG["dt"], t + CONFIG["dt"])
        T, p, X, V, total = ref.step(T, p, X, V, total, dt,
                                     R.boundary(deck.rows, t))
        # the port's Newton stops at a residual 1e-6 of its first and the
        # reference's at an update 1e-10 of the fields: they part by about
        # the update the port does not take (~1e-6 K here)
        assert float((T_p - T).abs().max()) < 1e-4
        assert rel(p_p, p) < 1e-9
        # the extents follow T through the Arrhenius rates (~1e-10 here)
        assert float((X_p - X).abs().max()) < 1e-8
        # the top moves by the lumped velocity, whose B'c follows the
        # surface T at d ln B'c / dT ~ 1/80 per K (~1e-7 relative here)
        assert total_p == pytest.approx(total, rel=1e-5)
        # the vertices by those velocities times 0.1 s (< 1e-14 m here)
        assert float((torch.as_tensor(V_p) - V).abs().max()) \
            < 1e-6 * float(total)


def test_smoother_runs_to_its_tolerance_on_the_deck_strip(tmp_path):
    """On the deck's 11 x 239 strip the smoothing CG runs to its rtol, as
    the reference's CGSolver does, and equals the direct solve to 1e2 rtol
    (the CG's stall exits would stop it after ~80 iterations at a relative
    residual ~8e-3, its velocity up to 87% off)."""
    from cmfem_tpu_torch.core import FESpace, load_gmsh
    from cmfem_tpu_torch.motion.recession import (MeshRecessionHandler,
                                                  smoothing_rtol)
    from cmfem_tpu_torch.utils.timing import StepTimer

    verts, quads, segs, attrs = R.strip_mesh(11, 239)
    mesh = load_gmsh(R.write_gmsh(str(tmp_path / "deck.msh"), verts, quads,
                                  segs, attrs))
    ref = R.Case22Reference(
        CONFIG["material"], verts, quads, segs[attrs == 3], segs[attrs == 1],
        R.bprime_rows(CONFIG["bprime"]), CONFIG["surface_model"], CPU)
    v = torch.zeros(len(verts), dtype=torch.float64)
    v[ref.top] = 1e-5
    w_ref = ref.mesh_velocity(torch.tensor(verts), v).numpy()
    handler = MeshRecessionHandler(
        mesh, FESpace(mesh, 1), bdr_attr_top=3, bdr_attr_bottom=1,
        device=CPU)
    timer = StepTimer()
    with timer.span("step"):
        handler.prepare_advance(v, 0.1)
    assert timer.counts["mesh_cg_iters"] > 200
    assert rel(handler.mesh_velocity[:, 1], w_ref) \
        < 100 * smoothing_rtol(torch.float64)
