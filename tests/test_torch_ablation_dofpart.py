"""Port parity, ``parallel/ablation_dofpart.py``:
``DofPartitionedAblationNewton`` on gloo worlds of 2 and 4 CPU ranks
against the JAX package's class on as many virtual devices, float64, on
the 3 x 20 order-1 strip of ``torch_ablation_helpers.newton_inputs``, in
the three cases of ``test_torch_ablation_sharded`` (static, SEB, a receded
case-2.2 mesh with ALE ``wq`` and ``gcl``).  The residual to 1e-12 of
max|R|, ``prepare``'s factors (the packed element blocks, the owned-slab
point-block factors and scaling) to 1e-12, the Newton direction per field
to 1e-7 with the same GMRES counts (the port's GMRES reduces its products
over the ranks: ``krylov.gmres(reduce=)``), the gathered outputs equal bit
for bit on every rank, the two-field layout's round trip, and
``per_device_floats`` equal to JAX's and shrinking with the rank count.
One spawn per world size."""

import numpy as np
import pytest

import torch_dist_helpers as H
from cmfem_tpu_torch.parallel import spawn_ranks
from torch_ablation_helpers import (  # noqa: F401
    jax_newton, max_rel, newton_inputs, one_torch_thread)

CASES = ["static", "seb", "receded"]
FLOATS = {}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return newton_inputs(tmp_path_factory.mktemp("strip"))


@pytest.fixture(scope="module", params=[2, 4])
def world(request, inputs):
    n = request.param
    pair, inp = inputs
    ranks = spawn_ranks(H.ablation_newton_checks, n, (n, "dofpart", inp),
                        timeout=180)
    return n, ranks, jax_newton("dofpart", pair, inp, n)


@pytest.mark.parametrize("case", CASES)
def test_residual_matches_jax(world, case):
    _, ranks, ref = world
    assert max_rel(ranks[0][case]["R"], ref[case]["R"]) < 1e-12


@pytest.mark.parametrize("case", CASES)
def test_prepare_factors_match_jax(world, case):
    _, ranks, ref = world
    got, want = ranks[0][case], ref[case]
    for k in ("Je_s", "pb", "s"):
        assert got[k].size == want[k].size, k
        assert max_rel(got[k].reshape(want[k].shape), want[k]) < 1e-12, k


@pytest.mark.parametrize("case", CASES)
def test_newton_direction_and_gmres_counts_match_jax(world, inputs, case):
    _, ranks, ref = world
    got, want = ranks[0][case], ref[case]
    n = len(inputs[1]["cases"][case]["T"])
    assert got["converged"] and want["converged"]
    assert (got["iters"], got["inner_iters"]) == (want["iters"],
                                                  want["inner_iters"])
    for f in (slice(0, n), slice(n, 2 * n)):
        assert max_rel(got["dx"][f], want["dx"][f]) < 1e-7


def test_gathered_outputs_equal_on_every_rank(world, inputs):
    """The gathered residual, direction and factors are the same bits on
    every rank, the layout round trip gives back (T, p) exactly, and every
    rank counted the same GMRES iterations."""
    _, ranks, _ = world
    T, p = (inputs[1]["cases"]["static"][k] for k in "Tp")
    for r in ranks:
        np.testing.assert_array_equal(r["roundtrip"][0], T)
        np.testing.assert_array_equal(r["roundtrip"][1], p)
        for case in CASES:
            for k in ("R", "pb", "s", "dx"):
                assert np.array_equal(r[case][k], ranks[0][case][k]), \
                    (r["rank"], case, k)
            assert r[case]["inner_iters"] == ranks[0][case]["inner_iters"]


def test_per_device_floats_match_jax_and_shrink(world):
    n, ranks, ref = world
    assert {r["per_device_floats"] for r in ranks} == {
        ref["per_device_floats"]}
    FLOATS[n] = ref["per_device_floats"]
    if len(FLOATS) == 2:
        assert FLOATS[4] < FLOATS[2]
