"""The output checks fail what they must: the control (the plain reference
in the program's place, in the precision below the configuration's) and
the timed path broken underneath (a step that returns its state
unchanged, an answer altered where it is produced), each on the CPU at a
small size; and the sound program passes.  The cells' limits are those of
``workloads/``; the readings they were set from, at the cells' own sizes on
the card, are in PERF.md."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

CPU = torch.device("cpu")


def make(cell_name, seed=2**31 + 5):
    """The cell built on the CPU at its small size (``small/<cell>.json``,
    the size every CPU test runs it at); a workload kept for a later cell
    (not in BENCHMARK.json) takes the configuration its name starts
    with."""
    bench = harness.load_benchmark(ROOT)
    config_name = cell_name.split(".")[0]
    cfg = harness.find(bench, "configs", config_name)
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    workload = {**harness.load_json("workloads", cell_name),
                **harness.load_json("small", cell_name)}
    cell = harness.load_module("kinds", workload["kind"]).Cell(
        config, workload, seed, CPU)
    cell.warm()
    return cell


def correct(cell, seconds=0.3, seed=2**31 + 11):
    cell.seed_inputs(seed)
    rec = cell.window(seconds)
    checks = cell.check()
    assert rec["attempted"] > 0
    return all(v <= lim for _, v, lim in checks), checks


@pytest.fixture(scope="module")
def steps():
    return make("cdr3d-p2.n48-steps")


@pytest.fixture(scope="module")
def applies():
    return make("cdr3d-p2.n48-applies")


@pytest.fixture(scope="module")
def tc1():
    cell = make("ablation-tc1.r0-lu")
    yield cell
    cell.release()


def test_steps_sound_program_passes(steps):
    ok, checks = correct(steps)
    assert ok, checks


def test_steps_control_fails(steps):
    keep = steps.step
    try:
        steps.use_control()
        ok, checks = correct(steps, 0.05)
    finally:
        steps.step = keep
    assert not ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_steps_fault_fails(steps, fault):
    keep = steps.step

    def broken(u, D):
        res = keep(u, D)
        if fault == "unchanged":
            return res._replace(x=u.clone())
        x = res.x.clone()
        x[len(x) // 2 + 3] += 1e-2 * float(x.abs().max())
        return res._replace(x=x)

    steps.step = broken
    try:
        ok, checks = correct(steps)
    finally:
        steps.step = keep
    assert not ok, checks


def test_applies_sound_program_passes(applies):
    ok, checks = correct(applies, 0.1)
    assert ok, checks


def test_applies_control_fails(applies):
    keep = applies.fn
    try:
        applies.use_control()
        ok, checks = correct(applies, 0.1)
    finally:
        applies.fn = keep
    assert not ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
def test_applies_fault_fails(applies, fault):
    keep = applies.fn

    def broken(v, D):
        if fault == "unchanged":
            return v.clone()
        y = keep(v, D)
        if fault == "altered":
            y[7] += 1e-2 * float(y.abs().max())
        else:  # half of the output left out
            y[: len(y) // 2] = 0.0
        return y

    applies.fn = broken
    try:
        ok, checks = correct(applies, 0.1)
    finally:
        applies.fn = keep
    assert not ok, checks


def test_tc1_sound_program_passes(tc1):
    ok, checks = correct(tc1, 0.1)
    assert ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_tc1_fault_fails(tc1, fault):
    """The committed step broken where the driver commits it."""
    system = tc1._system
    inner = system.advance_state_arrays
    last = {}

    def broken(sys_self, X_old, T, p, dt):
        if fault == "unchanged":
            # the state the step started from, committed as its answer
            prev = last.get("T", T.new_full(T.shape, 300.0))
            last["T"] = T.clone()
            T = prev
        else:
            T = T.clone()
            T[len(T) // 3] += 0.5
        return inner(sys_self, X_old, T, p, dt)

    system.advance_state_arrays = broken
    try:
        ok, checks = correct(tc1, 0.1)
    finally:
        system.advance_state_arrays = inner
    assert not ok, checks


def test_tc1_control_fails(tc1):
    keep = tc1._run
    try:
        tc1.use_control()
        ok, checks = correct(tc1, 0.1)
    finally:
        tc1._run = keep
    assert not ok, checks


@pytest.fixture(scope="module")
def r2():
    cell = make("ablation-tc1.r2-scan")
    yield cell
    cell.release()


def test_r2_sound_program_passes(r2):
    ok, checks = correct(r2, 2.0)
    assert ok, checks


def test_r2_control_fails(r2):
    keep = r2._run
    try:
        r2.use_control()
        ok, checks = correct(r2, 6.0)
    finally:
        r2._run = keep
    assert not ok, checks
