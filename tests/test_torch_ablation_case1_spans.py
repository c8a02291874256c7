"""The case-1 driver's spans and host-sync counter, eager (host LU) and
``scan_stepping``, on a 3 x 40 strip with the synthetic TACOT deck: each
run's set-up in its first timing row (``run_setup``) and its finish in the
last (``run_finish``); every row's ``step_wall`` holds its phases
(``total``); ``host_syncs`` counts the waits each step passes, exactly;
under ``torch.profiler`` the chrome trace holds the ``cmfem.*`` ranges
around the operations of their phases; and on the card every wait of a
step (a sync-debug warning, or an explicit ``torch.cuda.synchronize``)
falls at a counted site.  On the card, a run whose element Jacobians are
replayed from CUDA graphs equals the same run all eager."""

import json
import os
import traceback
import warnings

import pytest
import torch

# torch alone: the card's test runs in this file (no JAX)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "tacot_synthetic.json")
TOP = 3          # make_strip_mesh_2d's top boundary attribute
MODES = {"lu": {}, "scan": {"scan_stepping": True}}
# the waits of each step of the 2-step runs below (and of a 1-step run's
# step): the timer's syncs, the Newton loops' reads, the host LU's copies,
# the extent solves' convergence tests, the copies of host numbers (dt, the
# wall temperature, the deck's constants at first use), the state's
# diagnostics and the outputs (the scan path's frame at the run's last step)
SYNCS = {"lu": [216, 143], "scan": [244, 178]}
# a 1-step run's step on the card: the CPU's 216 (lu) and 258 (scan) less
# the waits of the three element-Jacobian calls after the first, which
# capture and replay a CUDA graph and wait for nothing (42: their extent
# sweeps' convergence tests and their copies of dt)
ONE_STEP = {"lu": 174, "scan": 216}
# the element-Jacobian calls of those steps (one a Newton iteration)
JACOBIANS = {"lu": [4, 3], "scan": [4, 3]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def strip(tmp_path_factory):
    from cmfem_tpu_torch.core import make_strip_mesh_2d, write_gmsh

    return write_gmsh(make_strip_mesh_2d(3, 40),
                      str(tmp_path_factory.mktemp("mesh") / "strip.msh"))


def _cfg(strip, out, steps, **extra):
    return {"mesh_file": strip, "material_file": FIXTURE, "order": 1,
            "dt": 0.1, "t_final": 0.1 * steps, "bdr_attr_top": TOP,
            "probe_x": 0.00125, "newton_print_level": 0,
            "save_paraview": False, "output_every": 2, "output_path": out,
            **extra}


class _NoRange:
    entered = []

    def __init__(self, name):
        _NoRange.entered.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rows_carry_the_run_spans_and_the_host_syncs(strip, tmp_path,
                                                     monkeypatch, mode):
    from cmfem_tpu_torch.apps import ablation_case1 as P

    _NoRange.entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _NoRange)
    rows = P.run(_cfg(strip, str(tmp_path), 2, **MODES[mode]),
                 device="cpu")["timing"]
    assert _NoRange.entered == []
    assert len(rows) == 2
    assert rows[0]["run_setup"] > 0 and "run_setup" not in rows[1]
    assert rows[-1]["run_finish"] > 0 and "run_finish" not in rows[0]
    assert all(r["step_wall"] >= r["total"] > 0 for r in rows)
    assert [r["host_syncs"] for r in rows] == SYNCS[mode]
    # on the CPU every element-Jacobian call is eager, and counted
    assert [r.get("jacobian_eager", 0) for r in rows] == JACOBIANS[mode]
    assert not any(k in r for r in rows
                   for k in ("jacobian_captures", "jacobian_replays"))
    # the per-step CSV keeps its columns
    with open(os.path.join(str(tmp_path), "driver_timing_per_step.csv")) as f:
        assert f.readline().strip() == (
            "step,bc_sec,newton_sec,newton_residual_eval_sec,"
            "newton_jacobian_sec,newton_linear_sec,newton_update_sec,"
            "state_advance_sec,output_sec,step_total_sec")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_profiled_run_holds_the_phase_ranges(strip, tmp_path, mode):
    from torch.profiler import ProfilerActivity, profile

    from cmfem_tpu_torch.apps import ablation_case1 as P

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.run(_cfg(strip, str(tmp_path / "out"), 1, **MODES[mode]),
              device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    for name in ("run_setup", "step", "jacobian", "residual"):
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == "cmfem." + name]
        assert ranges, name
        inside = [o for o in ops for r in ranges
                  if r["ts"] <= o["ts"] and
                  o["ts"] + o.get("dur", 0) <= r["ts"] + r["dur"]]
        assert inside, name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_wait_of_a_step_is_counted(strip, tmp_path, monkeypatch, mode):
    """One step on the card with ``torch.cuda.set_sync_debug_mode("warn")``:
    every sync-debug warning inside the step, and every explicit
    ``torch.cuda.synchronize``, must find a count made before it and not yet
    matched; at the step's end the counts and the waits are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.apps import ablation_case1 as P
    from cmfem_tpu_torch.utils import timing

    state = {"timer": None, "done": 0, "waits": 0, "uncounted": []}
    span, step_reset = timing.StepTimer.span, timing.StepTimer.step_reset

    def counted():
        t = state["timer"]
        return state["done"] + t.counts.get("host_syncs", 0)

    def wait(what):
        if state["timer"] is None:
            return
        state["waits"] += 1
        if state["waits"] > counted():
            state["uncounted"].append(
                what + "".join(traceback.format_stack(limit=8)[:-2]))
            state["waits"] = counted()

    def in_step(self, name):
        if name != "step":
            return span(self, name)

        class _Step:
            def __enter__(inner):
                state.update(timer=self, done=0, waits=0)
                inner.cm = span(self, name)
                return inner.cm.__enter__()

            def __exit__(inner, *exc):
                n = counted()
                state["timer"] = None
                out = inner.cm.__exit__(*exc)
                assert state["waits"] == n, (state["waits"], n)
                return out
        return _Step()

    def reset(self):
        out = step_reset(self)
        if self is state["timer"]:
            state["done"] += out.get("host_syncs", 0)
        return out

    synchronize = torch.cuda.synchronize

    def explicit(*args, **kwargs):
        wait("torch.cuda.synchronize\n")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return synchronize(*args, **kwargs)

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            wait(f"{message}\n")

    monkeypatch.setattr(timing.StepTimer, "span", in_step)
    monkeypatch.setattr(timing.StepTimer, "step_reset", reset)
    monkeypatch.setattr(torch.cuda, "synchronize", explicit)
    monkeypatch.setattr(warnings, "showwarning", show)
    cfg = _cfg(strip, str(tmp_path), 1, **MODES[mode])
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = P.run(cfg, device="cuda")["timing"]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert state["uncounted"] == [], "\n".join(state["uncounted"][:5])
    assert rows[0]["host_syncs"] == ONE_STEP[mode]


@pytest.mark.gpu
def test_graph_run_equals_eager_run(strip, tmp_path, monkeypatch):
    """A 3-step run on the card, its element Jacobians replayed from CUDA
    graphs after each key's eager call and capture, against the same run
    with the capture patched out (every call eager): the same Newton
    counts, T and p within 1e-10 of their largest values; the rows count
    the calls by kind, and ``bench_port``'s reader of
    ``jacobian_graph_replay_pct`` reads their share of replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from bench_port import harness
    from cmfem_tpu_torch.apps import ablation_case1 as P
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    graph = P.run(_cfg(strip, str(tmp_path / "graph"), 3), device="cuda")
    monkeypatch.setattr(AblationSystem, "_capture_jacobians",
                        lambda self, *args: None)
    eager = P.run(_cfg(strip, str(tmp_path / "eager"), 3), device="cuda")
    assert graph["newton_iters"] == eager["newton_iters"]
    for k in ("T", "p"):
        assert np.abs(graph[k] - eager[k]).max() <= \
            1e-10 * np.abs(eager[k]).max()
    calls = lambda out, k: sum(r.get(k, 0) for r in out["timing"])
    assert calls(graph, "jacobian_eager") == 1
    assert calls(graph, "jacobian_captures") == 1
    replays = calls(graph, "jacobian_replays")
    assert replays >= 1
    assert calls(eager, "jacobian_captures") == 0 == \
        calls(eager, "jacobian_replays")
    read = harness.load_module("metrics", "jacobian_graph_replay_pct").read
    assert read({"timing_rows": graph["timing"]}) == \
        pytest.approx(100.0 * replays / (replays + 2))
    assert read({"timing_rows": eager["timing"]}) == 0.0
