"""Port parity, ``solvers/blocksolve.py``: the strip dof lattice, the
equilibrated point-block GMRES (``BlockNewtonKrylov``, generic and stencil
(DIA) matvec) and the block-QR direct solver (``BlockTridiagDirect``) on a
real case-1 Newton system — the step-1 Jacobian of a 4 x 40 strip under the
synthetic TACOT deck, assembled by the JAX package and handed to both —
and on synthetic block systems against a dense solve, float64 on the CPU.
The block-QR solve reaches a relative residual of 1e-10 and agrees with
``scipy.sparse.linalg.spsolve`` and with the JAX solver; the GMRES takes
the JAX solver's iteration count; cuSOLVER/LAPACK may choose other signs
for Q and R, so only solutions are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from torch_ablation_helpers import FIXTURE, TOP, strip_file

from cmfem_tpu_torch.solvers import blocksolve as P


@pytest.fixture(scope="module")
def case1(tmp_path_factory):
    """The step-1 Newton system of case 1 (wall at 1644 K, the rest at
    300 K and one atmosphere, virgin extents, dt 0.1)."""
    from cmfem_tpu.core import FESpace, load_gmsh
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.ablation import AblationState, AblationSystem
    from cmfem_tpu.physics.tacot import TacotMaterial

    path = strip_file(tmp_path_factory.mktemp("strip"), 4, 40)
    fes = FESpace(load_gmsh(path), 1)
    n = fes.nscalar
    ops = SpaceOps(fes, quad_order=4)
    sys_ = AblationSystem(ops, TacotMaterial.load_yaml(FIXTURE), top_attr=TOP)
    ess = np.asarray(fes.boundary_dofs([TOP]))
    T = jnp.full(n, 300.0).at[jnp.asarray(ess)].set(1644.0)
    p = jnp.full(n, 101325.0)
    To = ops.values_at_qp(jnp.full(n, 300.0))
    po = ops.values_at_qp(p)
    X = jnp.asarray(AblationState.initial(sys_.ne, sys_.nq, sys_.mat).extent)
    blocks = [np.asarray(b) for b in
              sys_.element_jacobians(T, p, To, po, X, 0.1)]
    RT, Rp = sys_.residual(T, p, To, po, X, 0.1)
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    b = np.where(mask2, 0.0, -np.concatenate([np.asarray(RT),
                                               np.asarray(Rp)]))
    ed = np.asarray(fes.element_dofs, dtype=np.int64)
    return {"fes": fes, "n": n, "ed": ed, "ess": ess, "mask2": mask2,
            "blocks": blocks, "b": b, "A": _sparse(ed, n, blocks, mask2)}


def _sparse(ed, n, blocks, mask2):
    """The BC-eliminated 2n x 2n system (the host LU path's matrix)."""
    nd = ed.shape[1]
    rows_b = np.repeat(ed, nd, axis=1).reshape(-1)
    cols_b = np.tile(ed, (1, nd)).reshape(-1)
    rows = np.concatenate([rows_b, rows_b, rows_b + n, rows_b + n])
    cols = np.concatenate([cols_b, cols_b + n, cols_b, cols_b + n])
    vals = np.concatenate([b.reshape(-1) for b in blocks])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, 2 * n)).tocsr()
    d = sp.diags((~mask2).astype(np.float64))
    return (d @ A @ d + sp.diags(mask2.astype(np.float64))).tocsc()


def _tensors(blocks):
    return tuple(torch.tensor(b) for b in blocks)


def _rel2(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("order,jitter", [(1, 0.0), (2, 0.0), (1, 1e-12)])
def test_strip_dof_lattice_matches_jax(case1, tmp_path, order, jitter):
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice
    from cmfem_tpu_torch.core import FESpace, load_gmsh

    fes = FESpace(load_gmsh(strip_file(tmp_path, 3, 7)), order)
    pos = np.array(fes.node_positions)
    pos[:, 0] += jitter * np.sin(np.arange(len(pos)))
    lat = P.strip_dof_lattice(pos)
    np.testing.assert_array_equal(lat, strip_dof_lattice(pos))
    assert sorted(lat.reshape(-1)) == list(range(fes.nscalar))
    bad = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]])   # ragged columns
    with pytest.raises(ValueError):
        P.strip_dof_lattice(bad)
    with pytest.raises(ValueError):
        strip_dof_lattice(bad)


def test_block_tridiag_direct_solves_case1_system(case1):
    from cmfem_tpu.solvers.blocksolve import BlockTridiagDirect

    c = case1
    lat = P.strip_dof_lattice(c["fes"].node_positions)
    btd = P.BlockTridiagDirect(c["ed"], c["n"], c["ess"], c["ess"],
                               dof_lattice=lat, device="cpu")
    res = btd.solve(btd.prepare(_tensors(c["blocks"])), torch.tensor(c["b"]))
    x = res.x.numpy()
    assert res.converged and res.iters <= 2
    assert np.linalg.norm(c["A"] @ x - c["b"]) / np.linalg.norm(c["b"]) \
        < 1e-10
    assert np.abs(x[c["mask2"]]).max() == 0.0
    x_lu = spla.spsolve(c["A"], c["b"])
    jbtd = BlockTridiagDirect(c["ed"], c["n"], c["ess"], c["ess"],
                              dof_lattice=lat)
    xj = np.asarray(jbtd.solve(jbtd.prepare(
        tuple(jnp.asarray(b) for b in c["blocks"])), jnp.asarray(c["b"])).x)
    assert _rel2(x, x_lu) < 1e-8 and _rel2(x, xj) < 1e-8


@pytest.mark.parametrize("lattice", [False, True])
def test_block_gmres_takes_the_jax_iterations(case1, lattice):
    from cmfem_tpu.solvers import BlockNewtonKrylov

    c = case1
    lat = P.strip_dof_lattice(c["fes"].node_positions) if lattice else None
    kw = dict(restart=400, maxiter=10, dof_lattice=lat)
    bks = P.BlockNewtonKrylov(c["ed"], c["n"], c["ess"], c["ess"],
                              device="cpu", **kw)
    jbks = BlockNewtonKrylov(c["ed"], c["n"], c["ess"], c["ess"], **kw)
    x_lu = spla.spsolve(c["A"], c["b"])
    # at rtol 1e-9 and 1e-11 both packages take 86 and 89 Arnoldi steps with
    # a clear margin; at the drivers' 1e-10 the DIA count sits on the
    # boundary (87 here, 88 in JAX: the residual estimates differ in their
    # last digits there).  The iterates leave ~1e-5 and ~1e-9 of the LU
    # solution (the equilibrated system is ill conditioned)
    for rtol, steps, err in ((1e-9, 86, 1e-5), (1e-11, 89, 1e-8)):
        res = bks.solve(bks.prepare(_tensors(c["blocks"])),
                        torch.tensor(c["b"]), rtol=rtol)
        jres = jbks.solve(jbks.prepare(tuple(jnp.asarray(b)
                                             for b in c["blocks"])),
                          jnp.asarray(c["b"]), rtol=rtol)
        assert res.converged and bool(jres.converged)
        assert res.inner_iters == int(jres.inner_iters) == steps
        assert res.iters == int(jres.iters)
        assert _rel2(res.x.numpy(), x_lu) < err
        assert _rel2(res.x.numpy(), np.asarray(jres.x)) < err


def _synthetic(nx, ny, order, seed):
    from cmfem_tpu_torch.core import FESpace, make_cartesian_mesh_2d

    fes = FESpace(make_cartesian_mesh_2d(nx, ny, sx=0.0025, sy=0.05), order)
    n = fes.nscalar
    ed = np.asarray(fes.element_dofs, dtype=np.int64)
    ne, nd = ed.shape
    rng = np.random.default_rng(seed)
    eyed = np.eye(nd) * nd * 4.0
    blocks = [(rng.standard_normal((ne, nd, nd)) + eyed) * 1.0e2,
              rng.standard_normal((ne, nd, nd)) * 1.0e-3,
              rng.standard_normal((ne, nd, nd)) * 1.0e-3,
              (rng.standard_normal((ne, nd, nd)) + eyed) * 1.0e-6]
    ess = np.asarray(fes.boundary_dofs())
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    b = np.where(mask2, 0.0, rng.standard_normal(2 * n))
    return fes, n, ed, blocks, ess, mask2, b


@pytest.mark.parametrize("order,lattice,face", [
    (1, False, False), (1, True, False), (2, True, False), (1, False, True)])
def test_synthetic_block_systems_match_the_dense_solve(order, lattice, face):
    fes, n, ed, blocks, ess, mask2, b = _synthetic(5, 7, order, 2)
    nd = ed.shape[1]
    face_kw, full = {}, blocks
    if face:
        # boundary-face contributions to the T rows of the top elements
        rng = np.random.default_rng(3)
        top = np.arange(ed.shape[0] - 5, ed.shape[0])
        FJT = rng.standard_normal((5, nd, nd))
        FJp = rng.standard_normal((5, nd, nd)) * 1e-3
        face_kw = {"face": (torch.tensor(FJT), torch.tensor(FJp)),
                   "face_elem": top}
        full = [b.copy() for b in blocks]
        np.add.at(full[0], top, FJT)
        np.add.at(full[1], top, FJp)
    x_ref = spla.spsolve(_sparse(ed, n, full, mask2), b)
    lat = P.strip_dof_lattice(fes.node_positions) if lattice else None
    bks = P.BlockNewtonKrylov(ed, n, ess, ess, restart=80, maxiter=10,
                              dof_lattice=lat, device="cpu")
    res = bks.solve(bks.prepare(_tensors(blocks), **face_kw),
                    torch.tensor(b), rtol=1e-12)
    assert res.converged and _rel2(res.x.numpy(), x_ref) < 1e-9


def test_windowed_stencil_assembly_equals_index_add():
    fes, n, ed, blocks, ess, _, _ = _synthetic(4, 6, 1, 5)
    bks = P.BlockNewtonKrylov(ed, n, ess, ess, device="cpu",
                              dof_lattice=P.strip_dof_lattice(
                                  fes.node_positions))
    assert bks.wlat is not None
    S_win, pb_w, s_w = bks.prepare(_tensors(blocks))
    bks.wlat = None                      # the index_add_ assembly
    S_idx, pb_i, s_i = bks.prepare(_tensors(blocks))
    assert float((S_win - S_idx).abs().max()) \
        <= 1e-12 * float(S_idx.abs().max())
    torch.testing.assert_close(pb_w, pb_i, rtol=1e-12, atol=0)
    torch.testing.assert_close(s_w, s_i, rtol=1e-12, atol=0)


def test_block_tridiag_direct_matches_dense_on_a_synthetic_system():
    fes, n, ed, blocks, ess, mask2, b = _synthetic(5, 9, 1, 7)
    btd = P.BlockTridiagDirect(ed, n, ess, ess, device="cpu",
                               dof_lattice=P.strip_dof_lattice(
                                   fes.node_positions))
    res = btd.solve(btd.prepare(_tensors(blocks)), torch.tensor(b))
    x_ref = spla.spsolve(_sparse(ed, n, blocks, mask2), b)
    assert res.converged and _rel2(res.x.numpy(), x_ref) < 1e-11
    assert float(res.x[torch.tensor(mask2)].abs().max()) == 0.0


def test_solver_choice_and_refusals():
    fes, n, ed, _, ess, _, _ = _synthetic(3, 5, 1, 0)
    pos = fes.node_positions
    pick = lambda cfg, ed=ed, n=n, pos=pos: type(P.make_scan_block_solver(
        cfg, ed, n, ess, ess, pos, device="cpu")).__name__
    assert pick({}) == "BlockTridiagDirect"
    assert pick({"lattice_direct": False}) == "BlockNewtonKrylov"
    fes2, n2, ed2, _, ess2, _, _ = _synthetic(3, 5, 2, 0)
    solver = P.make_scan_block_solver({}, ed2, n2, ess2, ess2,
                                      fes2.node_positions, device="cpu")
    assert type(solver).__name__ == "BlockNewtonKrylov"
    assert solver.lattice is not None          # order 2: DIA GMRES
    # line MG needs a lattice, as in the JAX package
    with pytest.raises(ValueError, match="requires a dof lattice"):
        P.BlockNewtonKrylov(ed, n, ess, ess, pc="linemg", device="cpu")
    with pytest.raises(ValueError, match="unknown pc"):
        P.BlockNewtonKrylov(ed, n, ess, ess, pc="ilu", device="cpu")
    with pytest.raises(ValueError):
        P.BlockTridiagDirect(ed, n, ess, ess, dof_lattice=None,
                             device="cpu")


@pytest.mark.gpu
def test_cuda_block_tridiag_direct_equals_cpu(case1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = case1
    lat = P.strip_dof_lattice(c["fes"].node_positions)
    out = {}
    for dev in ("cpu", "cuda"):
        btd = P.BlockTridiagDirect(c["ed"], c["n"], c["ess"], c["ess"],
                                   dof_lattice=lat, device=dev)
        fac = btd.prepare(tuple(t.to(dev) for t in _tensors(c["blocks"])))
        out[dev] = btd.solve(fac, torch.tensor(c["b"], device=dev)).x.cpu()
    assert _rel2(out["cuda"].numpy(), out["cpu"].numpy()) < 1e-8
