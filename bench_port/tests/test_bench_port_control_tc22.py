"""The output check of ``ablation-tc22.r0-lu`` fails what it must, on the
CPU at the cell's small size (``small/ablation-tc22.r0-lu.json``): the
control (the plain reference in the program's place, in float32) and the
program broken where it commits a step's parts (a step that leaves the
vertices unmoved, the recession velocity 1% off, T 0.5 K off at one entry,
the extent remap taking each point's extents from the wrong donor); and
the sound program passes.  A skipped extent remap is no fault on this
traffic: the top recedes a few micrometres a step, well under the top
cell's spacing of quadrature points, so every point is its own donor and
the remap leaves the extents as they are (checked here).  A window of one
run still judges sampled steps alone, and the warm-up refuses a program
whose mesh-velocity CG stops before its tolerance.  The limits are
those of ``workloads/``; the readings they were set from, at the cell's
own size on the card, are in PERF.md.

Run: ``python -m pytest bench_port/tests -q``."""

import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port.tests.test_bench_port_control import correct, make  # noqa: E402

CELL = "ablation-tc22.r0-lu"


@pytest.fixture(scope="module")
def tc22():
    cell = make(CELL)
    yield cell
    cell.release()


def test_sound_program_passes(tc22):
    # a window of more than one run: the later runs' steps are sampled
    ok, checks = correct(tc22, 30.0)
    assert len(tc22.runs) > 1 and tc22.sample.items
    assert ok, checks


def test_control_fails(tc22):
    keep = tc22._run
    try:
        tc22.use_control()
        ok, checks = correct(tc22, 0.1)
    finally:
        tc22._run = keep
    assert not ok, checks


def test_one_run_window_is_sampled(tc22):
    ok, checks = correct(tc22, 0.1)
    assert len(tc22.runs) == 1 and tc22.sample.items == [(0, 1)]
    assert ok, checks
    assert all(0.0 < v for name, v, _ in checks
               if name in ("T_max_abs_K", "p_max_rel")), checks


def test_warm_refuses_a_cg_stopped_early(tc22):
    from cmfem_tpu_torch.motion import recession

    def capped(cg):
        def run(*args, **kwargs):
            return cg(*args, **{**kwargs, "maxiter": 3})
        return run

    with _patched(recession, "cg", capped):
        with pytest.raises(RuntimeError, match="before its tolerance"):
            tc22.warm()


@contextmanager
def _patched(owner, name, make_broken):
    """``owner.name`` replaced by ``make_broken(original)`` in a context."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(owner, name, make_broken(getattr(owner, name)))
        yield


def unmoved(commit):
    def broken(handler):
        # the step committed as one that does not recede
        handler._pending_mean_v = 0.0
        return commit(handler)
    return broken


def velocity_off(velocity):
    def broken(*args, **kwargs):
        return 1.01 * velocity(*args, **kwargs)
    return broken


def temperature_off(advance):
    def broken(sys_self, X_old, T, p, dt):
        T = T.clone()
        T[len(T) // 3] += 0.5
        return advance(sys_self, X_old, T, p, dt)
    return broken


def wrong_donor(remap):
    def broken(mesh, ops, extent, w, dt, vertices):
        out = remap(mesh, ops, extent, w, dt, vertices)
        return np.roll(out, 1, axis=1)
    return broken


def _targets():
    from cmfem_tpu_torch.apps import ablation_case2_2
    from cmfem_tpu_torch.motion.recession import MeshRecessionHandler
    from cmfem_tpu_torch.physics.ablation import AblationSystem

    return {"unmoved": (MeshRecessionHandler, "commit_advance", unmoved),
            "velocity": (AblationSystem, "top_boundary_recession_velocity",
                         velocity_off),
            "temperature": (None, "advance_state_arrays", temperature_off),
            "wrong_donor": (ablation_case2_2, "remap_extents_ale",
                            wrong_donor)}


@pytest.mark.parametrize("fault", ["unmoved", "velocity", "temperature",
                                   "wrong_donor"])
def test_fault_fails(tc22, fault):
    owner, name, make_broken = _targets()[fault]
    # the committed state is wrapped by the cell: break it underneath
    owner = owner or tc22._system
    with _patched(owner, name, make_broken):
        ok, checks = correct(tc22, 0.1)
    assert not ok, checks


def test_remap_is_the_identity_on_this_traffic(tc22):
    """Every quadrature point's donor is itself: a skipped remap changes
    no output, so it is no fault the check can see."""
    from cmfem_tpu_torch.apps import ablation_case2_2

    seen = []

    def watch(remap):
        def run(mesh, ops, extent, w, dt, vertices):
            out = remap(mesh, ops, extent, w, dt, vertices)
            seen.append(np.abs(out - extent.cpu().numpy()).max())
            return out
        return run

    with _patched(ablation_case2_2, "remap_extents_ale", watch):
        ok, checks = correct(tc22, 0.1)
    assert ok, checks
    assert seen and max(seen) == 0.0
