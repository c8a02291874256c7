"""``solvers.krylov.gmres(reduce=)``: GMRES on vectors split over ranks.

On a gloo world of 2 CPU ranks, each holding its rows of a seeded
nonsymmetric system, the hooked GMRES takes the whole-vector GMRES's
iterations (restart cycles and Arnoldi steps, two restart lengths) and its
x to 1e-12 relative; each Arnoldi step makes three reductions (one per
Gram-Schmidt pass, all ``restart + 1`` products at once, and one norm),
plus a fixed few per restart cycle.  In one process an identity ``reduce``
(a world of one) gives the counts of the plain path.  Without ``reduce``
the present GMRES (its Givens state in numpy scalars) computes what the
port's GMRES computed before, bit for bit (``torch_gmres_before``):
float64 and float32, preconditioned, from a start vector, over restarts,
at the Krylov space's exhaustion, at the cycle cap and at a stagnation
exit."""

import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from torch_gmres_before import gmres as gmres_before
from cmfem_tpu_torch.parallel import spawn_ranks
from cmfem_tpu_torch.solvers import gmres

N = 60


def _system():
    rng = np.random.default_rng(5)
    A = np.diag(rng.uniform(2.0, 20.0, N)) + rng.standard_normal((N, N)) / 2
    return A, rng.standard_normal(N)


def _whole(A, b, restart, reduce=None):
    At = torch.as_tensor(A)
    d = torch.as_tensor(np.diag(A).copy())
    return gmres(lambda v: At @ v, torch.as_tensor(b), M=lambda r: r / d,
                 rtol=1e-10, restart=restart, maxiter=20, reduce=reduce)


@pytest.fixture(scope="module")
def ranks():
    A, b = _system()
    return {m: spawn_ranks(H.gmres_slab_checks, 2, (2, A, b, m), timeout=120)
            for m in (8, 50)}


@pytest.mark.parametrize("restart", [8, 50])
def test_slab_gmres_matches_whole_vector(ranks, restart):
    A, b = _system()
    ref = _whole(A, b, restart)
    assert ref.converged
    for r in ranks[restart]:
        assert r["converged"]
        assert (r["iters"], r["inner_iters"]) == (ref.iters, ref.inner_iters)
        x = ref.x.numpy()
        assert np.abs(r["x"] - x).max() <= 1e-12 * np.abs(x).max()
    np.testing.assert_array_equal(ranks[restart][0]["x"],
                                  ranks[restart][1]["x"])


@pytest.mark.parametrize("restart", [8, 50])
def test_one_reduction_per_gram_schmidt_pass(ranks, restart):
    """3 reductions per Arnoldi step; per restart cycle one for its start
    vector's norm and one for the explicit residual; two before the
    loop."""
    r = ranks[restart][0]
    assert r["calls"] == 3 * r["inner_iters"] + 2 * r["iters"] + 2


@pytest.mark.parametrize("restart", [8, 50])
def test_identity_reduce_takes_the_plain_counts(restart):
    A, b = _system()
    plain = _whole(A, b, restart)
    hooked = _whole(A, b, restart, reduce=lambda t: t)
    assert (hooked.iters, hooked.inner_iters, hooked.converged) == \
        (plain.iters, plain.inner_iters, plain.converged)
    assert torch.allclose(hooked.x, plain.x, rtol=0, atol=1e-13)


def _cases():
    """(name, apply_A, b, kwargs): the systems the bit-for-bit test runs."""
    A, b = _system()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    d = torch.as_tensor(np.diag(A).copy())
    A32, b32 = At.float(), bt.float()
    rng = np.random.default_rng(9)
    # four distinct eigenvalues: the Krylov space is exhausted after 4
    lam = torch.as_tensor(rng.choice([1.0, 2.0, 5.0, 9.0], N))
    yield "f64 jacobi", (lambda v: At @ v), bt, dict(M=lambda r: r / d)
    yield "f64 x0 restarts", (lambda v: At @ v), bt, dict(
        x0=torch.as_tensor(rng.standard_normal(N)), restart=5, rtol=1e-13)
    yield "f32", (lambda v: A32 @ v), b32, dict(M=lambda r: r / d.float(),
                                                 rtol=1e-6)
    yield "exhaustion", (lambda v: lam * v), bt, dict(restart=20)
    yield "cycle cap", (lambda v: At @ v), bt, dict(restart=3, maxiter=4,
                                                    rtol=1e-14)
    # GMRES(1) on a nearly skew operator: <r, A r> ~ 0, no progress
    S = rng.standard_normal((N, N))
    St = torch.as_tensor(S - S.T + 1e-3 * np.eye(N))
    yield "stagnation", (lambda v: St @ v), bt, dict(restart=1)


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_without_reduce_bit_for_bit_as_before(case):
    _, apply_A, b, kw = next(c for c in _cases() if c[0] == case)
    kw = {"rtol": 1e-10, "restart": 50, "maxiter": 20, **kw}
    got = gmres(apply_A, b, **kw)
    want = gmres_before(apply_A, b, **kw)
    assert torch.equal(got.x, want.x)
    assert got[1:] == want[1:]
    if case == "stagnation":
        assert got.stagnated and not got.converged
