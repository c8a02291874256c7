"""Port parity, ``solvers/linemg.py``: the seven functions of the line
multigrid and ``StripLineMG.apply`` against the JAX package in float64 on
the CPU (1e-12 relative; ``line_solve`` 1e-10), and ``BlockNewtonKrylov(
pc="linemg")`` on the cases of ``tests/test_linemg.py`` (the dense oracle,
the h-robust PDE system, the order-1 refusal) and on a real case-1 Newton
system: the same inner GMRES counts as JAX's and true residuals within
1e-8.  QR signs may differ between LAPACK builds (and cuSOLVER), so the
factors are compared through the solves they give.  The element blocks are
made once, by the JAX package, and handed to both.  The line kernels'
arithmetic is emulated in numpy (``_kernel_factor``, ``_kernel_solve``)
and held to the plain versions and to JAX's; the ``gpu`` tests run the
kernels on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfem_tpu_torch.solvers import blocksolve as P
from cmfem_tpu_torch.solvers import linemg as L


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _pde_blocks(fes, kappa_T=1.0e2, kappa_p=1.0e-6, coup=1.0e-3):
    """(T, p)-shaped element blocks from a mass + diffusion operator, as in
    ``tests/test_linemg.py`` (numpy)."""
    from cmfem_tpu.ops import BilinearForm, SpaceOps

    ops = SpaceOps(fes, quad_order=3)
    diff = BilinearForm(ops).add_diffusion(1.0).add_mass(10.0)
    Ae = np.asarray(diff.element_matrices(diff.assemble()))
    mass = BilinearForm(ops).add_mass(1.0)
    Me = np.asarray(mass.element_matrices(mass.assemble()))
    return (kappa_T * Ae, coup * Me, -0.5 * coup * Me, kappa_p * Ae)


def _strip(nx, ny, order=1):
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    fes = FESpace(make_cartesian_mesh_2d(nx, ny, sx=0.0025, sy=0.05), order)
    return fes, strip_dof_lattice(fes.node_positions)


def _pair(fes, lat, restart, maxiter, ess=None):
    from cmfem_tpu.solvers import BlockNewtonKrylov as JBNK

    n = fes.nscalar
    ed = np.asarray(fes.element_dofs)
    ess = np.asarray(fes.boundary_dofs()) if ess is None else ess
    jb = JBNK(ed, n, ess, ess, restart=restart, maxiter=maxiter,
              dof_lattice=lat, pc="linemg")
    tb = P.BlockNewtonKrylov(ed, n, ess, ess, restart=restart,
                             maxiter=maxiter, dof_lattice=lat, pc="linemg",
                             device="cpu")
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    return jb, tb, mask2


@pytest.fixture(scope="module")
def stencil():
    """A real equilibrated (4, KO, NY, NX) stencil of a 7 x 9 strip and its
    lattice mask, from the JAX solver's ``prepare`` (point-block mode)."""
    from cmfem_tpu.solvers import BlockNewtonKrylov as JBNK

    fes, lat = _strip(6, 8)
    n = fes.nscalar
    ess = np.asarray(fes.boundary_dofs([3]))
    jb = JBNK(np.asarray(fes.element_dofs), n, ess, ess, dof_lattice=lat)
    S, _, _ = jb.prepare(tuple(jnp.asarray(b) for b in _pde_blocks(fes)))
    Lj = jb.lattice
    return (np.asarray(S), Lj["offs"], Lj["NY"], Lj["NX"],
            np.asarray(Lj["mask2_lat"]), n)


def test_canonical_stencil_and_matvec_match_jax(stencil):
    from cmfem_tpu.solvers import linemg as J

    S, offs, NY, NX, mask, n = stencil
    SSj = J.canonical_stencil(jnp.asarray(S), offs, NY, NX,
                              jnp.asarray(mask), n)
    SSt = L.canonical_stencil(_t(S), offs, NY, NX, _t(mask), n)
    assert _rel(SSt, SSj) <= 1e-12
    z = np.random.default_rng(0).standard_normal((NY, NX, 2))
    assert _rel(L.stencil_matvec(SSt, _t(z)),
                J.stencil_matvec(SSj, jnp.asarray(z))) <= 1e-12
    bad = offs + [(2, 0)]
    with pytest.raises(ValueError, match="order-1 strips"):
        L.canonical_stencil(_t(np.concatenate([S, S[:, :1]], axis=1)), bad,
                            NY, NX, _t(mask), n)


@pytest.mark.parametrize("NX", [7, 8, 1])
def test_semicoarsen_restrict_prolong_match_jax(stencil, NX):
    from cmfem_tpu.solvers import linemg as J

    S, offs, NY, NX0, mask, n = stencil
    SS = np.asarray(J.canonical_stencil(jnp.asarray(S), offs, NY, NX0,
                                        jnp.asarray(mask), n))[:, :, :, :NX]
    assert _rel(L.semicoarsen_x(_t(SS)),
                J.semicoarsen_x(jnp.asarray(SS))) <= 1e-12
    rng = np.random.default_rng(NX)
    r = rng.standard_normal((NY, NX, 2))
    assert _rel(L.restrict_x(_t(r)), J.restrict_x(jnp.asarray(r))) <= 1e-12
    ec = rng.standard_normal((NY, (NX + 1) // 2, 2))
    assert _rel(L.prolong_x(_t(ec), NX),
                J.prolong_x(jnp.asarray(ec), NX)) <= 1e-12


def test_line_factor_and_solve_match_jax(stencil):
    """The factors agree up to the signs QR may choose: |R| entrywise and
    C1, E row by row with R's signs; the solves to 1e-10."""
    from cmfem_tpu.solvers import linemg as J

    S, offs, NY, NX, mask, n = stencil
    SSj = J.canonical_stencil(jnp.asarray(S), offs, NY, NX,
                              jnp.asarray(mask), n)
    SSt = L.canonical_stencil(_t(S), offs, NY, NX, _t(mask), n)
    fj = [np.asarray(a) for a in J.line_factor(SSj)]
    ft = [a.numpy() for a in L.line_factor(SSt)]
    for a, b in zip(ft, fj):
        assert a.shape == b.shape
    R_t, R_j = ft[0], fj[0]
    assert _rel(np.abs(R_t), np.abs(R_j)) <= 1e-12
    sign = np.sign(np.diagonal(R_t, axis1=-2, axis2=-1)) \
        * np.sign(np.diagonal(R_j, axis1=-2, axis2=-1))    # (NY-1, NX, 2)
    for k in (1, 2):   # C1 and E: rows flip with R's
        assert _rel(ft[k] * sign[..., None], fj[k]) <= 1e-12
    r = np.random.default_rng(1).standard_normal((NY, NX, 2))
    assert _rel(L.line_solve(tuple(map(torch.as_tensor, ft)), _t(r)),
                J.line_solve(tuple(map(jnp.asarray, fj)),
                             jnp.asarray(r))) <= 1e-10


def test_strip_line_mg_apply_matches_jax(stencil):
    from cmfem_tpu.solvers.linemg import StripLineMG as JMG

    S, offs, NY, NX, mask, n = stencil
    jm, tm = JMG(NY, NX, offs), L.StripLineMG(NY, NX, offs)
    assert tm.nxs == jm.nxs
    arrs_j = jm.setup(jnp.asarray(S), jnp.asarray(mask), n)
    arrs_t = tm.setup(_t(S), _t(mask), n)
    r = np.random.default_rng(2).standard_normal(2 * n)
    for m in (None, mask):
        yj = jm.apply(arrs_j, jnp.asarray(r),
                      mask=None if m is None else jnp.asarray(m))
        yt = tm.apply(arrs_t, _t(r), mask=None if m is None else _t(m))
        assert _rel(yt, yj) <= 1e-10
    assert (yt.numpy()[mask] == r[mask]).all()
    # two sweeps per smoothing
    jm2, tm2 = JMG(NY, NX, offs, nu=2), L.StripLineMG(NY, NX, offs, nu=2)
    assert _rel(tm2.apply(tm2.setup(_t(S), _t(mask), n), _t(r)),
                jm2.apply(jm2.setup(jnp.asarray(S), jnp.asarray(mask), n),
                          jnp.asarray(r))) <= 1e-10


def _true_rel(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def _dense_from_blocks(eldofs, n, blocks, mask2):
    JTT, JTp, JpT, Jpp = blocks
    A = np.zeros((2 * n, 2 * n))
    for e, dofs in enumerate(np.asarray(eldofs)):
        ix = np.ix_(dofs, dofs)
        A[ix] += JTT[e]
        A[np.ix_(dofs, dofs + n)] += JTp[e]
        A[np.ix_(dofs + n, dofs)] += JpT[e]
        A[np.ix_(dofs + n, dofs + n)] += Jpp[e]
    A[mask2, :] = 0.0
    A[:, mask2] = 0.0
    A[mask2, mask2] = 1.0
    return A


def test_linemg_matches_dense_oracle():
    """As tests/test_linemg.py: pc='linemg' reproduces the dense
    BC-eliminated solve (1e-8), with JAX's inner count."""
    fes, lat = _strip(5, 7)
    n = fes.nscalar
    blocks = _pde_blocks(fes)
    jb, tb, mask2 = _pair(fes, lat, 40, 5)
    A = _dense_from_blocks(fes.element_dofs, n, blocks, mask2)
    b = np.where(mask2, 0.0, np.random.default_rng(3).standard_normal(2 * n))
    x_ref = np.linalg.solve(A, b)
    rj = jb.solve(jb.prepare(tuple(jnp.asarray(B) for B in blocks)),
                  jnp.asarray(b), rtol=1e-12)
    rt = tb.solve(tb.prepare(tuple(map(_t, blocks))), _t(b), rtol=1e-12)
    x = rt.x.numpy()
    assert rt.converged
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8
    assert np.abs(x[mask2]).max() == 0.0
    assert rt.inner_iters == int(rj.inner_iters)
    assert rt.iters == int(rj.iters)
    assert abs(_true_rel(A, x, b)
               - _true_rel(A, np.asarray(rj.x), b)) <= 1e-8


def test_linemg_h_robust_on_pde_system():
    """As tests/test_linemg.py: the inner counts stay flat under uniform
    refinement, and equal JAX's at every level."""
    inners = []
    for nx, ny in ((6, 60), (12, 120), (24, 240)):
        fes, lat = _strip(nx, ny)
        n = fes.nscalar
        blocks = _pde_blocks(fes)
        jb, tb, mask2 = _pair(fes, lat, 60, 5)
        b = np.where(mask2, 0.0,
                     np.random.default_rng(4).standard_normal(2 * n))
        rj = jb.solve(jb.prepare(tuple(jnp.asarray(B) for B in blocks)),
                      jnp.asarray(b), rtol=1e-10)
        rt = tb.solve(tb.prepare(tuple(map(_t, blocks))), _t(b), rtol=1e-10)
        assert rt.converged, (nx, ny)
        assert rt.inner_iters == int(rj.inner_iters), (nx, ny)
        assert _rel(rt.x, rj.x) <= 1e-8, (nx, ny)
        inners.append(rt.inner_iters)
    assert max(inners) <= 40, inners
    for a, b_ in zip(inners, inners[1:]):
        assert b_ <= 1.5 * max(a, 8), inners


def test_linemg_requires_order1_lattice():
    """Order-2 stencils (25-point) exceed the 3x3 footprint: refused at
    construction in the JAX package's words."""
    fes, lat = _strip(4, 6, order=2)
    z = np.zeros(0, np.int64)
    with pytest.raises(ValueError, match="order-1 strips"):
        P.BlockNewtonKrylov(np.asarray(fes.element_dofs), fes.nscalar, z, z,
                            dof_lattice=lat, pc="linemg", device="cpu")
    with pytest.raises(ValueError, match="requires a dof lattice"):
        P.BlockNewtonKrylov(np.asarray(fes.element_dofs), fes.nscalar, z, z,
                            pc="linemg", device="cpu")


def test_linemg_on_a_case1_newton_system(tmp_path):
    """The step-1 Newton system of case 1 on a 4 x 40 strip (the JAX
    package's Jacobian, handed to both): point-block and line-MG GMRES
    take JAX's inner counts at rtol 1e-11 (at 1e-10 the point-block count
    sits on the boundary, 87 against 88), and the true residuals are JAX's
    within 1e-8 (the converged flag is not compared: known problem 3)."""
    import scipy.sparse.linalg as spla

    from test_torch_blocksolve import _sparse
    from torch_ablation_helpers import FIXTURE, TOP, strip_file

    from cmfem_tpu.core import FESpace, load_gmsh
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.ablation import AblationState, AblationSystem
    from cmfem_tpu.physics.tacot import TacotMaterial
    from cmfem_tpu.solvers import BlockNewtonKrylov as JBNK
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    fes = FESpace(load_gmsh(strip_file(tmp_path, 4, 40)), 1)
    n = fes.nscalar
    ops = SpaceOps(fes, quad_order=4)
    sys_ = AblationSystem(ops, TacotMaterial.load_yaml(FIXTURE), top_attr=TOP)
    ess = np.asarray(fes.boundary_dofs([TOP]))
    T = jnp.full(n, 300.0).at[jnp.asarray(ess)].set(1644.0)
    p = jnp.full(n, 101325.0)
    To, po = ops.values_at_qp(jnp.full(n, 300.0)), ops.values_at_qp(p)
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
    A = _sparse(ed, n, blocks, mask2)
    x_ref = spla.spsolve(A, b)
    lat = strip_dof_lattice(fes.node_positions)
    for pc in ("linemg", "pointblock"):
        jb = JBNK(ed, n, ess, ess, restart=400, maxiter=10, dof_lattice=lat,
                  pc=pc)
        tb = P.BlockNewtonKrylov(ed, n, ess, ess, restart=400, maxiter=10,
                                 dof_lattice=lat, pc=pc, device="cpu")
        rj = jb.solve(jb.prepare(tuple(jnp.asarray(B) for B in blocks)),
                      jnp.asarray(b), rtol=1e-11)
        rt = tb.solve(tb.prepare(tuple(map(_t, blocks))), _t(b), rtol=1e-11)
        assert rt.inner_iters == int(rj.inner_iters), pc
        tr_t = _true_rel(A, rt.x.numpy(), b)
        tr_j = _true_rel(A, np.asarray(rj.x), b)
        assert abs(tr_t - tr_j) <= 1e-8, (pc, tr_t, tr_j)
        if pc == "linemg":
            # the direction against the direct solve, field by field
            for sl in (slice(0, n), slice(n, 2 * n)):
                assert np.linalg.norm(rt.x.numpy()[sl] - x_ref[sl]) \
                    <= 1e-6 * np.linalg.norm(x_ref[sl]), pc
            lin = rt.inner_iters
        else:
            pb = rt.inner_iters
    assert lin < pb, (lin, pb)


def test_neumaier_dot_matches_jax():
    """``krylov.neumaier_dot`` against JAX's, with and without padding of
    the last chunk; in float32 it stays within a few eps of the float64
    dot where the plain float32 sum may not."""
    from cmfem_tpu.solvers.krylov import neumaier_dot as jnd

    from cmfem_tpu_torch.solvers.krylov import cg, neumaier_dot

    rng = np.random.default_rng(6)
    for n, chunks in ((10_000, 256), (1001, 7), (5, 256)):
        a, b = rng.standard_normal(n), rng.standard_normal(n)
        assert abs(float(neumaier_dot(_t(a), _t(b), chunks))
                   - float(jnd(jnp.asarray(a), jnp.asarray(b), chunks))) \
            <= 1e-13 * np.abs(a * b).sum()
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        got = float(neumaier_dot(_t(a32), _t(b32), chunks))
        ref = float(jnd(jnp.asarray(a32), jnp.asarray(b32), chunks))
        assert got == pytest.approx(ref, rel=0, abs=2e-6 * np.abs(a * b).sum())
    # as CG's dot: the same iterate as the plain dot in float64
    A = np.diag(np.linspace(1.0, 10.0, 50))
    bb = rng.standard_normal(50)
    r1 = cg(lambda v: _t(A) @ v, _t(bb), rtol=1e-12, dot=neumaier_dot)
    r2 = cg(lambda v: _t(A) @ v, _t(bb), rtol=1e-12)
    assert r1.iters == r2.iters and r1.converged
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), rtol=1e-10)


@pytest.mark.gpu
def test_cuda_linemg_matches_cpu_on_a_pde_system():
    """On the card (phase 14a's check at small size): line-MG GMRES on the
    6 x 60 PDE system, through the line-factor and line-solve kernels,
    takes the CPU's inner count, and its solution equals the CPU's and the
    dense oracle's to 1e-8 (QR signs may differ between the kernel and
    LAPACK: only solves are compared)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.kernels import linemg as K

    fes, lat = _strip(6, 60)
    n = fes.nscalar
    blocks = _pde_blocks(fes)
    ed = np.asarray(fes.element_dofs)
    ess = np.asarray(fes.boundary_dofs())
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    b = np.where(mask2, 0.0, np.random.default_rng(4).standard_normal(2 * n))
    x_ref = np.linalg.solve(_dense_from_blocks(ed, n, blocks, mask2), b)
    out = {}
    for dev in ("cpu", "cuda"):
        before = (K.launches_factor, K.launches_solve)
        tb = P.BlockNewtonKrylov(ed, n, ess, ess, restart=60, maxiter=5,
                                 dof_lattice=lat, pc="linemg", device=dev)
        res = tb.solve(tb.prepare(tuple(_t(B).to(dev) for B in blocks)),
                       _t(b).to(dev), rtol=1e-10)
        out[dev] = (res.inner_iters, res.x.cpu().numpy())
        moved = (K.launches_factor - before[0], K.launches_solve - before[1])
        assert (min(moved) > 0) == (dev == "cuda"), (dev, moved)
    assert out["cuda"][0] == out["cpu"][0]
    for x in (out["cpu"][1], x_ref):
        assert np.linalg.norm(out["cuda"][1] - x) <= 1e-8 * np.linalg.norm(x)


def _householder(alpha, x):
    """LAPACK dlarfg, as csrc/linemg.cu::householder: (beta, tau, v)."""
    xn2 = sum(xi * xi for xi in x)
    if xn2 == 0.0:
        return alpha, 0.0, [0.0] * len(x)
    norm = np.sqrt(alpha * alpha + xn2)
    beta = -norm if alpha >= 0 else norm
    s = 1.0 / (alpha - beta)
    return beta, (beta - alpha) / beta, [xi * s for xi in x]


def _kernel_factor(SS):
    """csrc/linemg.cu::line_factor_kernel, one column at a time, in numpy:
    the same arithmetic in the same order (the chain thread's rows 2-3 of
    H2 H1 W and warp 1's outputs are the same products)."""
    Al, Ad, Au = (np.asarray(SS[i, 1]) for i in range(3))
    NY, NX = Ad.shape[:2]
    R, C1, E = (np.zeros((NY - 1, NX, 2, 2)) for _ in range(3))
    Q = np.zeros((NY - 1, NX, 4, 4))
    Qf, Rf = np.zeros((NX, 2, 2)), np.zeros((NX, 2, 2))
    for x in range(NX):
        Dc, Cc = Ad[0, x].copy(), Au[0, x].copy()
        for y in range(1, NY):
            M = np.vstack([Dc, Al[y, x]])
            W = np.vstack([np.hstack([Cc, np.zeros((2, 2))]),
                           np.hstack([Ad[y, x], Au[y, x]])])
            b1, t1, v1 = _householder(M[0, 0], M[1:, 0])
            u1 = np.array([1.0, *v1])
            M[:, 1] -= t1 * u1 * (u1 @ M[:, 1])
            b2, t2, v2 = _householder(M[1, 1], M[2:, 1])
            u2 = np.array([0.0, 1.0, *v2])
            W -= t1 * np.outer(u1, u1 @ W)
            W -= t2 * np.outer(u2, u2 @ W)
            H1 = np.eye(4) - t1 * np.outer(u1, u1)
            Q[y - 1, x] = H1 - t2 * np.outer(H1 @ u2, u2)
            R[y - 1, x] = [[b1, M[0, 1]], [0.0, b2]]
            C1[y - 1, x], E[y - 1, x] = W[:2, :2], W[:2, 2:]
            Dc, Cc = W[2:, :2].copy(), W[2:, 2:].copy()
        beta, tau, (v,) = _householder(Dc[0, 0], [Dc[1, 0]])
        w = Dc[0, 1] + v * Dc[1, 1]
        Rf[x] = [[beta, Dc[0, 1] - tau * w], [0.0, Dc[1, 1] - tau * v * w]]
        Qf[x] = [[1 - tau, -tau * v], [-tau * v, 1 - tau * v * v]]
    return R, C1, E, Q, Qf, Rf


def _comb(first, second):
    """The affine map ``second`` after ``first``: (A2 A1, A2 b1 + b2)."""
    (A1, b1), (A2, b2) = first, second
    return A2 @ A1, np.einsum("...ab,...b->...a", A2, b1) + b2


def _apply(F, z):
    A, b = F
    return np.einsum("...ab,...b->...a", A, z) + b


def _upper_recip(Rm, b):
    """R^{-1} b by R's reciprocal diagonal, as the kernel's backward walk."""
    x1 = b[..., 1] * (1.0 / Rm[..., 1, 1])
    x0 = (b[..., 0] - Rm[..., 0, 1] * x1) * (1.0 / Rm[..., 0, 0])
    return np.stack([x0, x1], axis=-1)


def _upper(Rm, b):
    x1 = b[..., 1] / Rm[..., 1, 1]
    x0 = (b[..., 0] - Rm[..., 0, 1] * x1) / Rm[..., 0, 0]
    return np.stack([x0, x1], axis=-1)


def _run_bounds(rows, geometry):
    """{(block, thread): (first row, end)} of line_solve's kernel."""
    T, C, seg, run = geometry
    out = {}
    for k in range(C):
        a, b = min(k * seg, rows), min(min(k * seg, rows) + seg, rows)
        for t in range(T):
            ya = min(a + t * run, b)
            out[k, t] = (ya, min(ya + run, b))
    return out


def _forward_scan(maps, C, T):
    """The zc entering each thread's run: the run maps ``maps[k, t]`` (A,
    b) scanned as csrc/linemg.cu::line_solve_kernel does, over each warp's
    lanes in log steps (lane l takes lane l - off's total first), the
    warps' totals in order, then the cluster's blocks' totals in order."""
    W, zin = T // 32, {}
    for k in range(C):
        wtot, incl = [], {}
        for w in range(W):
            lanes = [maps[k, 32 * w + l] for l in range(32)]
            for off in (1, 2, 4, 8, 16):
                lanes = [_comb(lanes[l - off], lanes[l]) if l >= off
                         else lanes[l] for l in range(32)]
            incl[w] = lanes
            wtot.append(lanes[31])
        tot = wtot[0]
        for w in range(1, W):
            tot = _comb(tot, wtot[w])
        maps[k, "block"] = tot
        for w in range(W):
            z = np.zeros_like(maps[0, 0][1])
            for j in range(k):
                z = _apply(maps[j, "block"], z)
            for w2 in range(w):
                z = _apply(wtot[w2], z)
            for l in range(32):
                zin[k, 32 * w + l] = _apply(incl[w][l - 1], z) if l else z
    return zin


def _kernel_solve(fac, r, geometry=None):
    """csrc/linemg.cu::line_solve_kernel in numpy, all columns at once: the
    NY - 1 rows split into the cluster's blocks and the threads' runs
    (``kernels.linemg.solve_geometry``, or ``geometry`` = (threads,
    cluster, seg, run)); the forward sweep's affine maps (P_y, S_y r_{y+1})
    composed per run, scanned (``_forward_scan``) and replayed from the
    incoming zc; the backward sweep one walk down the rows from x_{NY-1},
    each row scaled by R's reciprocal diagonal."""
    from cmfem_tpu_torch.kernels.linemg import solve_geometry

    R, C1, E, Q, Qf, Rf = (np.asarray(a) for a in fac)
    NY, NX = r.shape[:2]
    rows = NY - 1
    T, C, seg, run = geometry or solve_geometry(NY, NX, r.itemsize)
    out = np.zeros_like(r)
    zl = lambda z: np.einsum("xba,xb->xa", Qf, z)  # noqa: E731
    if rows == 0:
        out[0] = _upper(Rf, zl(r[0]))
        return out
    runs = _run_bounds(rows, (T, C, seg, run))
    maps = {}
    for (k, t), (ya, yb) in runs.items():
        if (k, t) == (0, 0):
            A, b = np.zeros((NX, 2, 2)), r[0].copy()
        else:
            A, b = np.broadcast_to(np.eye(2), (NX, 2, 2)), np.zeros((NX, 2))
        for y in range(ya, yb):
            P = np.swapaxes(Q[y][:, :2, 2:], -1, -2)
            S = np.swapaxes(Q[y][:, 2:, 2:], -1, -2)
            A, b = P @ A, np.einsum("xab,xb->xa", P, b) \
                + np.einsum("xab,xb->xa", S, r[y + 1])
        maps[k, t] = (A, b)
    zin = _forward_scan(maps, C, T)
    zin[0, 0] = r[0]
    Z = np.zeros((rows, NX, 2))
    for kt, (ya, yb) in runs.items():
        z = zin[kt]
        for y in range(ya, yb):
            zz = np.einsum("xba,xb->xa", Q[y],
                           np.concatenate([z, r[y + 1]], axis=-1))
            Z[y], z = zz[:, :2], zz[:, 2:]
        if ya < yb == rows:
            out[NY - 1] = _upper(Rf, zl(z))
    # the walk: R01, C1, E and Z scaled by R's reciprocal diagonal row by
    # row (the forward replay's), the newest value x_{y+1}[0] entering last
    inv = 1.0 / np.stack([R[..., 0, 0], R[..., 1, 1]], -1)   # (rows, NX, 2)
    r01, c, e, z = R[..., 0, 1] * inv[..., 0], C1 * inv[..., None], \
        E * inv[..., None], Z * inv
    x1, x2 = out[NY - 1], np.zeros((NX, 2))
    for y in range(rows - 1, -1, -1):
        s = z[y] - np.einsum("xab,xb->xa", e[y], x2)
        n1 = s[:, 1] - c[y][:, 1, 1] * x1[:, 1] - c[y][:, 1, 0] * x1[:, 0]
        n0 = (s[:, 0] - c[y][:, 0, 1] * x1[:, 1] - c[y][:, 0, 0] * x1[:, 0]
              - r01[y] * n1)
        x = np.stack([n0, n1], -1)
        out[y], x1, x2 = x, x, x1
    return out


def test_kernel_arithmetic_matches_plain(stencil):
    """The kernels' arithmetic (Householder QR with LAPACK's conventions;
    the solve's scanned forward sweep and backward walk), emulated in
    numpy, gives the plain versions' factors (1e-12; the conventions are
    LAPACK's, so the signs agree) and solves (1e-10)."""
    from cmfem_tpu_torch.kernels.linemg import (line_factor_plain,
                                                line_solve_plain)

    S, offs, NY, NX, mask, n = stencil
    SS = L.canonical_stencil(_t(S), offs, NY, NX, _t(mask), n)
    fk = _kernel_factor(SS.numpy())
    fp = [a.numpy() for a in line_factor_plain(SS)]
    for a, b in zip(fk, fp):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-12
    r = np.random.default_rng(5).standard_normal((NY, NX, 2))
    assert _rel(_kernel_solve(fk, r),
                line_solve_plain(tuple(map(torch.as_tensor, fp)),
                                 _t(r))) <= 1e-10


def _random_stencil(NY, NX, seed):
    """A (3, 3, NY, NX, 2, 2) stencil whose line blocks (ox = 0) make a
    block-diagonally dominant system with fields of unequal scale."""
    rng = np.random.default_rng(seed)
    SS = np.zeros((3, 3, NY, NX, 2, 2))
    scale = np.array([1.0, 1e-3])[:, None]
    SS[1, 1] = (4.0 * np.eye(2) + 0.3 * rng.standard_normal((NY, NX, 2, 2))) \
        * scale
    for oy in (0, 2):
        SS[oy, 1] = (-np.eye(2) + 0.3 * rng.standard_normal(
            (NY, NX, 2, 2))) * scale
    return SS


@pytest.fixture(scope="module")
def strip600():
    """The line stencil of the (T, p) PDE system of a 3 x 600 strip (NY =
    601: the kernel's cluster of 5 blocks), from the JAX solver's
    ``prepare``."""
    from cmfem_tpu.solvers import BlockNewtonKrylov as JBNK

    fes, lat = _strip(3, 600)
    n = fes.nscalar
    ess = np.asarray(fes.boundary_dofs([3]))
    jb = JBNK(np.asarray(fes.element_dofs), n, ess, ess, dof_lattice=lat)
    S, _, _ = jb.prepare(tuple(jnp.asarray(b) for b in _pde_blocks(fes)))
    Lj = jb.lattice
    return L.canonical_stencil(_t(S), Lj["offs"], Lj["NY"], Lj["NX"],
                               _t(np.asarray(Lj["mask2_lat"])), n).numpy()


# (system, geometry): None takes solve_geometry's; the others force every
# level of the scan at small sizes (two warps or one, 2-8 blocks, runs of
# up to 3 rows)
SCAN_CASES = [("fixture", None), ("fixture", (32, 2, 4, 1)),
              ("fixture", (64, 3, 3, 1)), ("strip600", None),
              ("strip600", (64, 4, 150, 3)), ("strip600", (32, 8, 75, 3))] \
    + [((NY, NX), None) for NY in (1, 2, 3, 37) for NX in (1, 5)] \
    + [((4098, 1), None)]


def _case_id(case, geometry):
    name = case if isinstance(case, str) else "NY%d-NX%d" % case
    return name + "-" + ("kernel" if geometry is None
                         else "x".join(map(str, geometry)))


@pytest.mark.parametrize("case,geometry", SCAN_CASES,
                         ids=[_case_id(c, g) for c, g in SCAN_CASES])
def test_kernel_solve_emulation_matches_plain_and_jax(case, geometry,
                                                      request):
    """The redesigned ``line_solve`` (the forward sweep scanned over the
    kernel's runs, warps and cluster blocks, the backward walk on rows
    scaled by R's reciprocal diagonal), emulated in numpy, equals
    ``line_solve_plain`` and the JAX package's ``line_solve`` on the same
    factors to 1e-10 in float64: on the module's stencil, on a strip's
    line stencil of 601 rows, on seeded stencils at NY = 1, 2, 3, 37 and
    NX = 1, 5, and at NY = 4,098, one row more than a cluster stages (the
    runs of 5 rows whose last rows the kernel keeps in device memory)."""
    from cmfem_tpu.solvers import linemg as J

    from cmfem_tpu_torch.kernels.linemg import (line_factor_plain,
                                                line_solve_plain,
                                                solve_geometry)

    if case == "fixture":
        S, offs, NY, NX, mask, n = request.getfixturevalue("stencil")
        SS = L.canonical_stencil(_t(S), offs, NY, NX, _t(mask), n).numpy()
    elif case == "strip600":
        SS = request.getfixturevalue("strip600")
    else:
        SS = _random_stencil(*case, seed=sum(case))
    NY, NX = SS.shape[2], SS.shape[3]
    if geometry is None:
        geometry = solve_geometry(NY, NX, 8)
    T, C, seg, run = geometry
    assert C * seg >= NY - 1 and T * run >= seg
    fac = [a.numpy() for a in line_factor_plain(_t(SS))]
    r = np.random.default_rng(NY + NX).standard_normal((NY, NX, 2))
    xk = _kernel_solve(fac, r, geometry)
    assert _rel(xk, line_solve_plain(tuple(map(torch.as_tensor, fac)),
                                     _t(r))) <= 1e-10
    assert _rel(xk, J.line_solve(tuple(map(jnp.asarray, fac)),
                                 jnp.asarray(r))) <= 1e-10


# (NY, NX, itemsize): (threads, cluster, seg, run); the runs reach past
# shared memory's 32 / itemsize rows beyond NY = 4,097 (float64) and 8,193
# (float32), the strip refined 5 times (NY = 7,649) among them
GEOMETRIES = {(240, 12, 8): (128, 2, 120, 1), (957, 45, 8): (128, 2, 478, 4),
              (1913, 89, 8): (128, 4, 478, 4), (4097, 1, 8): (128, 8, 512, 4),
              (4098, 1, 8): (128, 8, 513, 5), (7649, 353, 8): (128, 1, 7648, 60),
              (7649, 45, 8): (128, 8, 956, 8), (7649, 89, 8): (128, 4, 1912, 15),
              (8193, 1, 4): (128, 8, 1024, 8), (8194, 1, 4): (128, 8, 1025, 9),
              (1, 1, 8): (128, 1, 0, 0)}


@pytest.mark.parametrize("shape", list(GEOMETRIES),
                         ids=["NY%d-NX%d-%dB" % k for k in GEOMETRIES])
def test_solve_geometry(shape):
    """``line_solve``'s launch geometry: the fewest blocks that stage a
    column (raised to fill the card at small NX), at most 8; past that as
    many blocks as one wave of the card holds, with runs longer than
    shared memory holds, and no size is refused."""
    from cmfem_tpu_torch.kernels.linemg import solve_geometry

    assert solve_geometry(*shape) == GEOMETRIES[shape]


def _scanned_backward(fac, r):
    """``line_solve`` with its backward sweep scanned as well (a design the
    kernel does not ship): the forward sweep as ``_kernel_solve``'s, then
    each run's maps of the state (x_y, x_{y+1}) composed (the top run from
    x_{NY-1}), scanned from the top down over ``solve_geometry``'s runs as
    ``_forward_scan`` scans, and each run replayed from its incoming
    state; float64."""
    from cmfem_tpu_torch.kernels.linemg import solve_geometry

    R, C1, E, Q, Qf, Rf = fac
    NY, NX = r.shape[:2]
    rows = NY - 1
    xk = _kernel_solve(fac, r)            # for x_{NY-1}
    Z, z = np.zeros((rows, NX, 2)), r[0]
    for y in range(rows):
        zz = np.einsum("xba,xb->xa", Q[y], np.concatenate([z, r[y + 1]], -1))
        Z[y], z = zz[:, :2], zz[:, 2:]
    runs = _run_bounds(rows, solve_geometry(NY, NX, 8))
    order = sorted((kt for kt in runs if runs[kt][0] < runs[kt][1]),
                   key=lambda kt: -runs[kt][0])
    eye4, zero2 = np.broadcast_to(np.eye(4), (NX, 4, 4)), np.zeros((NX, 2))
    s_top = np.concatenate([xk[NY - 1], zero2], -1)

    def step(y, x1, x2, Zy, solve=_upper_recip):
        return solve(R[y], Zy - np.einsum("xab,xb->xa", C1[y], x1)
                     - np.einsum("xab,xb->xa", E[y], x2))

    maps = {}
    for i, kt in enumerate(order):
        G, g = eye4, (s_top if i == 0 else np.zeros((NX, 4)))
        for y in range(runs[kt][1] - 1, runs[kt][0] - 1, -1):
            top = np.stack([step(y, G[:, :2, j], G[:, 2:, j], zero2)
                            for j in range(4)], axis=-1)
            G = np.concatenate([top, G[:, :2]], axis=1)
            g = np.concatenate([step(y, g[:, :2], g[:, 2:], Z[y]), g[:, :2]],
                               -1)
        maps[0, i] = (np.zeros_like(G) if i == 0 else G, g)
    n = -(-len(order) // 32) * 32
    for i in range(len(order), n):
        maps[0, i] = (eye4, np.zeros((NX, 4)))
    sin = _forward_scan(maps, 1, n)
    sin[0, 0] = s_top
    out = xk.copy()
    for i, kt in enumerate(order):
        x1, x2 = sin[0, i][:, :2], sin[0, i][:, 2:]
        for y in range(runs[kt][1] - 1, runs[kt][0] - 1, -1):
            x = step(y, x1, x2, Z[y], _upper)
            out[y], x1, x2 = x, x, x1
    return out


def test_backward_sweep_is_a_walk_not_a_scan(tmp_path):
    """Why ``line_solve``'s backward sweep stays a recurrence: on the line
    stencil of case 1's first Newton system (5,760 DOFs, the finest level,
    NY = 240), scanning it as well leaves a line residual |A x - r| / |r|
    more than 100 times the kernel's walk's, while the walk's stays within
    10 times the plain solve's (the composed maps of the backward state are
    blocks of the inverse upper factor and grow with the conditioning; the
    forward maps are blocks of orthogonal matrices)."""
    from cmfem_tpu_torch.apps import ablation_case1
    from cmfem_tpu_torch.kernels.linemg import line_solve_plain
    from cmfem_tpu_torch.profiling import first_newton_system
    from cmfem_tpu_torch.solvers.blocksolve import strip_dof_lattice

    c, blocks, _ = first_newton_system("cpu", str(tmp_path), 0, "walk")
    bks = P.BlockNewtonKrylov(c.fes.element_dofs, c.n, c.ess, c.ess,
                              dof_lattice=strip_dof_lattice(
                                  c.fes.node_positions),
                              pc="linemg", device="cpu")
    SS, fac = bks.prepare(blocks)[1][0]
    c.finish({k: 0.0 for k in ablation_case1.TIMING_KEYS
              + ("newton", "total")}, 0.0)
    NY, NX = SS.shape[2], SS.shape[3]
    line = SS.clone()
    line[:, 0] = 0.0
    line[:, 2] = 0.0
    r = np.random.default_rng(8).standard_normal((NY, NX, 2))
    f = [a.numpy() for a in fac]

    def resid(x):
        return float(np.linalg.norm(L.stencil_matvec(line, _t(x)).numpy()
                                    - r) / np.linalg.norm(r))

    plain = resid(line_solve_plain(fac, _t(r)).numpy())
    walk, scan = resid(_kernel_solve(f, r)), resid(_scanned_backward(f, r))
    print(f"line residual: plain {plain:.3e}, kernel (walk) {walk:.3e}, "
          f"scanned backward {scan:.3e}")
    assert walk <= 10 * plain, (walk, plain)
    assert scan >= 100 * walk, (scan, walk)


@pytest.mark.gpu
def test_cuda_line_kernels_match_plain(stencil):
    """On the card: the line-factor and line-solve kernels against their
    plain versions (on the host) through the solves, in float64 (1e-10)
    and float32 (1e-4: the 2x2 field blocks span orders of magnitude), on
    the module's stencil, on seeded stencils at the edge shapes (NY = 1, 2,
    3, 37 at NX = 1 and 5), at the main path's cluster sizes (NY = 957
    at NX = 45 and 1, NY = 1,913 at NX = 89, and NY = 4,097, the most a
    cluster stages in float64) and past them (NY = 4,500 at NX = 3, rows
    in device memory in float64; NY = 9,000 at NX = 1 and 200, in both
    precisions);
    one launch each, and a second solve on the same inputs equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.kernels import linemg as K

    S, offs, NY, NX, mask, n = stencil
    cases = [L.canonical_stencil(_t(S), offs, NY, NX, _t(mask), n).numpy()]
    cases += [_random_stencil(ny, nx, seed=ny + nx)
              for ny, nx in [(ny, nx) for ny in (1, 2, 3, 37) for nx in (1, 5)]
              + [(957, 45), (957, 1), (1913, 89), (4097, 1), (4500, 3),
                 (9000, 1), (9000, 200)]]
    for SSn in cases:
        ny, nx = SSn.shape[2], SSn.shape[3]
        r_np = np.random.default_rng(ny + nx).standard_normal((ny, nx, 2))
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            SS = torch.as_tensor(SSn, dtype=dtype, device="cuda")
            r = torch.as_tensor(r_np, dtype=dtype, device="cuda")
            before = (K.launches_factor, K.launches_solve)
            fac = K.line_factor(SS)
            xk = K.line_solve(fac, r)
            assert (K.launches_factor, K.launches_solve) == (
                before[0] + 1, before[1] + 1), (ny, nx, dtype)
            assert torch.equal(K.line_solve(fac, r), xk), (ny, nx, dtype)
            xp = K.line_solve_plain(K.line_factor_plain(SS.cpu()), r.cpu())
            err = float((xk.cpu() - xp).abs().max() / xp.abs().max())
            assert err <= tol, (ny, nx, dtype, err)


@pytest.mark.gpu
def test_cuda_solve_geometry_is_the_wrappers():
    """The built kernel's launch geometry (``csrc/linemg.cu``'s rule) equals
    ``kernels.linemg.solve_geometry``, which the CPU emulation follows, over
    NY = 1 to 10,000 and NX = 1 to 400 in both precisions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.kernels import linemg as K

    for NY in (1, 2, 3, 37, 129, 240, 479, 957, 1913, 3825, 4097, 4098,
               7649, 8193, 8194, 10000):
        for NX in (1, 2, 3, 5, 12, 23, 45, 66, 89, 133, 177, 353, 400):
            for itemsize in (4, 8):
                assert K.kernel_solve_geometry(NY, NX, itemsize) == \
                    K.solve_geometry(NY, NX, itemsize), (NY, NX, itemsize)
