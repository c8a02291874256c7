"""Port parity, ``parallel/ablation_sharded.py``: ``ShardedAblationNewton``
on gloo worlds of 2 and 4 CPU ranks against the JAX package's class on as
many virtual devices, float64, on the 3 x 20 order-1 strip of
``torch_ablation_helpers.newton_inputs`` (the synthetic deck, a
mid-heating state carried from JAX, the JAX geometric factors), in three
cases: static (case 1), SEB (case 2.1) and a receded case-2.2 mesh with an
ALE mesh velocity and a GCL pair.  The residual to 1e-12 of max|R|,
``prepare``'s factors (the element blocks, the point-block factors and the
scaling) to 1e-12, the Newton direction per field to 1e-7 with the same
GMRES counts; the ranks' replicated outputs equal bit for bit; one
``newton_step``.  One spawn per world size."""

import numpy as np
import pytest

import torch_dist_helpers as H
from cmfem_tpu_torch.parallel import spawn_ranks
from torch_ablation_helpers import (  # noqa: F401
    jax_newton, max_rel, newton_inputs, one_torch_thread)

CASES = ["static", "seb", "receded"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return newton_inputs(tmp_path_factory.mktemp("strip"))


@pytest.fixture(scope="module", params=[2, 4])
def world(request, inputs):
    n = request.param
    pair, inp = inputs
    ranks = spawn_ranks(H.ablation_newton_checks, n, (n, "sharded", inp),
                        timeout=180)
    return n, ranks, jax_newton("sharded", pair, inp, n)


@pytest.mark.parametrize("case", CASES)
def test_residual_matches_jax(world, case):
    _, ranks, ref = world
    assert max_rel(ranks[0][case]["R"], ref[case]["R"]) < 1e-12


@pytest.mark.parametrize("case", CASES)
def test_prepare_factors_match_jax(world, case):
    _, ranks, ref = world
    got, want = ranks[0][case], ref[case]
    Je_s = got["Je_s"].reshape(want["Je_s"].shape)
    assert max_rel(Je_s, want["Je_s"]) < 1e-12
    for k in ("pb", "s"):
        assert got[k].shape == want[k].shape, k
        assert max_rel(got[k], want[k]) < 1e-12, k


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


def test_replicated_outputs_equal_on_every_rank(world):
    """Every rank holds the same bits of the residual, the point-block
    factors, the scaling and the direction (the fixed-order scatters):
    their GMRES loops took the same exits."""
    _, ranks, _ = world
    for r in ranks[1:]:
        for case in CASES:
            for k in ("R", "pb", "s", "dx"):
                assert np.array_equal(r[case][k], ranks[0][case][k]), \
                    (r["rank"], case, k)
            assert r[case]["inner_iters"] == ranks[0][case]["inner_iters"]
