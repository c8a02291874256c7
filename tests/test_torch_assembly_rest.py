"""Port parity, the rest of the assembly layer: the face tabulations and
factors, ``geometric_factors``/``factors_for``, ``grads_at_qp``,
``integrate``, matrix diffusion, SUPG, custom quadrature-point data, element
and dense matrices, the boundary and SUPG linear forms, the weighted and
nodal error norms and ``EssentialBC.constrain_dense``, each against the JAX
function on quads, triangles and hexes from the same numpy-seeded inputs, in
float64 to rtol/atol 1e-12 (same algebra, other summation order); the
gradient of the mesh volume with respect to the vertices against
``jax.grad`` to 1e-10; and the element-stage choice of the element-batched
operators by shape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace
from cmfem_tpu.core import geometry as jgeom
from cmfem_tpu.core import (
    make_cartesian_mesh_2d as j_mesh2d,
    make_cartesian_mesh_3d as j_mesh3d,
)
from cmfem_tpu.ops import BilinearForm as JForm, EssentialBC as JBC
from cmfem_tpu.ops import SpaceOps as JSpaceOps
from cmfem_tpu.ops import assembly as jasm

from cmfem_tpu_torch.core import (
    FESpace, factors_for, make_cartesian_mesh_2d, make_cartesian_mesh_3d,
    make_tet_mesh,
)
from cmfem_tpu_torch.kernels.btdb import KERNEL_SHAPES
from cmfem_tpu_torch.ops import BilinearForm, EssentialBC, SpaceOps
from cmfem_tpu_torch.ops import assembly as tasm
from cmfem_tpu_torch.ops.partial import (
    PAOperator, StructuredGrid3D, StructuredPAOperator, element_path,
)

TOL = dict(rtol=1e-12, atol=1e-12)
MESHES = ["quad", "triangle", "hex"]


def _meshes(kind):
    if kind == "hex":
        return j_mesh3d(2, 3, 2), make_cartesian_mesh_3d(2, 3, 2)
    return (j_mesh2d(3, 4, geom=kind), make_cartesian_mesh_2d(3, 4, geom=kind))


def _pair(kind, order=2, moved=False):
    """(jops, ops) on the same mesh; with ``moved`` the vertices carry a
    smooth seeded displacement, so that no factor is constant."""
    jmesh, mesh = _meshes(kind)
    if moved:
        rng = np.random.default_rng(7)
        v = mesh.vertices + 0.03 * rng.standard_normal(mesh.vertices.shape)
        jmesh, mesh = jmesh.with_vertices(v), mesh.with_vertices(v)
    return (JSpaceOps(JFESpace(jmesh, order)),
            SpaceOps(FESpace(mesh, order), device="cpu"))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _u(ops, seed=0):
    u = np.random.default_rng(seed).standard_normal(ops.fes.nscalar)
    return jnp.asarray(u), torch.as_tensor(u)


def _data_close(data, jdata):
    for f in ("d00", "d01", "d10", "d11"):
        a, b = getattr(data, f), getattr(jdata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b)


def _smooth(x):
    """A coefficient both packages can evaluate: polynomial in x."""
    return 1.0 + 0.5 * x[:, 0] ** 2 + 0.25 * x[:, -1]


@pytest.mark.parametrize("kind", MESHES)
def test_face_tabulations_and_factors_match(kind):
    jops, ops = _pair(kind, moved=True)
    for key in ("B", "G", "Bgeo", "Ggeo", "dofs", "conn", "normal_sign"):
        _close(ops.face[key], jops.face[key])
    np.testing.assert_array_equal(ops.face["attr"], jops.face["attr"])
    jff, ff = jops.face_factors(), ops.face_factors()
    for f in ("wdS", "normal", "xq"):
        _close(getattr(ff, f), getattr(jff, f))
    # moved vertices passed explicitly
    v = np.asarray(ops.fes.mesh.vertices) * 1.1
    jff, ff = jops.face_factors(v), ops.face_factors(v)
    for f in ("wdS", "normal", "xq"):
        _close(getattr(ff, f), getattr(jff, f))


@pytest.mark.parametrize("kind", MESHES)
def test_geometric_factors_and_factors_for_match(kind):
    jops, ops = _pair(kind, moved=True)
    v = np.asarray(ops.fes.mesh.vertices)
    jgf = jops.geometric_factors(v)
    for gf in (ops.geometric_factors(v),
               ops.geometric_factors(torch.as_tensor(v)),
               factors_for(ops.fes.mesh, ops.quad),
               factors_for(ops.fes.mesh, ops.quad, coords=v)):
        for f in ("detJ", "invJ", "wdetJ", "xq"):
            _close(getattr(gf, f), getattr(jgf, f))
    jgf = jgeom.factors_for(jops.fes.mesh, jops.quad, coords=1.2 * v)
    gf = factors_for(ops.fes.mesh, ops.quad, coords=torch.as_tensor(1.2 * v))
    for f in ("detJ", "invJ", "wdetJ", "xq"):
        _close(getattr(gf, f), getattr(jgf, f))
    with pytest.raises(NotImplementedError):
        factors_for(ops.fes.mesh, ops.quad, geom_order=2)


@pytest.mark.parametrize("kind", MESHES)
def test_grads_at_qp_and_integrate_match(kind):
    jops, ops = _pair(kind, moved=True)
    ju, u = _u(ops)
    _close(ops.grads_at_qp(u), jops.grads_at_qp(ju))
    _close(ops.values_at_qp(u), jops.values_at_qp(ju))
    q = ops.values_at_qp(u) ** 2
    _close(ops.integrate(q), jops.integrate(jops.values_at_qp(ju) ** 2))
    # with factors of moved vertices
    v = np.asarray(ops.fes.mesh.vertices) * 0.9
    _close(ops.grads_at_qp(u, ops.geometric_factors(v)),
           jops.grads_at_qp(ju, jops.geometric_factors(v)))


@pytest.mark.parametrize("kind", MESHES)
def test_volume_gradient_matches_jax_grad(kind):
    """d(volume)/d(vertices) through ``geometric_factors``: autograd against
    ``jax.grad``, 1e-10."""
    jops, ops = _pair(kind, moved=True)
    v = np.asarray(ops.fes.mesh.vertices)

    def jvol(x):
        gf = jops.geometric_factors(x)
        return jops.integrate(jnp.ones_like(gf.wdetJ), gf)

    vt = torch.as_tensor(v).requires_grad_(True)
    gf = ops.geometric_factors(vt)
    vol = ops.integrate(torch.ones_like(gf.wdetJ), gf)
    (g,) = torch.autograd.grad(vol, vt)
    _close(vol, jvol(jnp.asarray(v)))
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jvol)(
        jnp.asarray(v))), rtol=1e-10, atol=1e-10)


def _matrix_coeff(x):
    """A symmetric positive matrix coefficient (n, dim, dim), in either
    array module."""
    dim = x.shape[1]
    xp = torch if torch.is_tensor(x) else jnp
    eye = xp.eye(dim, dtype=x.dtype) if xp is torch else jnp.eye(dim)
    return (1.0 + x[:, 0] ** 2)[:, None, None] * eye \
        + 0.1 * x[:, :, None] * x[:, None, :]


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("part", ["diffusion_matrix", "supg", "qpdata"])
def test_integrators_match(kind, part):
    jops, ops = _pair(kind, moved=True)
    dim = ops.fes.mesh.dim
    beta = np.array([1.0, -2.0, 0.5])[:dim]
    if part == "diffusion_matrix":
        jform = JForm(jops).add_diffusion_matrix(_matrix_coeff)
        form = BilinearForm(ops).add_diffusion_matrix(_matrix_coeff)
    elif part == "supg":
        jform = JForm(jops).add_supg(beta, _smooth, reaction=0.7)
        form = BilinearForm(ops).add_supg(beta, _smooth, reaction=0.7)
    else:
        jform = JForm(jops).add_mass(2.0).add_qpdata(
            lambda gf: jasm.OperatorData(d00=gf.wdetJ * gf.xq[..., 0],
                                         d10=gf.invJ[..., 0] * gf.wdetJ[..., None]))
        form = BilinearForm(ops).add_mass(2.0).add_qpdata(
            lambda gf: tasm.OperatorData(d00=gf.wdetJ * gf.xq[..., 0],
                                         d10=gf.invJ[..., 0] * gf.wdetJ[..., None]))
    jdata, data = jform.assemble(), form.assemble()
    _data_close(data, jdata)
    ju, u = _u(ops, 1)
    _close(form.apply(data, u), jform.apply(jdata, ju))
    _close(form.assemble_diagonal(data), jform.assemble_diagonal(jdata))


def test_supg_small_peclet_branch_matches():
    """kappa so large that Pe < 1e-4 everywhere: the series branch."""
    jops, ops = _pair("quad", order=1)
    beta = np.array([1.0, 0.5])
    jd = JForm(jops).add_supg(beta, 1e6).assemble()
    d = BilinearForm(ops).add_supg(beta, 1e6).assemble()
    _data_close(d, jd)
    assert torch.isfinite(d.d11).all()


def _cdr_forms(jops, ops):
    dim = ops.fes.mesh.dim
    beta = np.array([1.0, -2.0, 0.5])[:dim]
    jform = (JForm(jops).add_diffusion(_smooth).add_convection(beta)
             .add_mass(0.7).add_supg(beta, 0.05))
    form = (BilinearForm(ops).add_diffusion(_smooth).add_convection(beta)
            .add_mass(0.7).add_supg(beta, 0.05))
    return jform, form


@pytest.mark.parametrize("kind", MESHES)
def test_element_and_dense_matrices_match(kind):
    jops, ops = _pair(kind, order=2 if kind != "hex" else 1, moved=True)
    jform, form = _cdr_forms(jops, ops)
    jdata, data = jform.assemble(), form.assemble()
    _close(form.element_matrices(data), jform.element_matrices(jdata))
    A = form.dense_matrix(data)
    _close(A, jform.dense_matrix(jdata))
    # dense_matrix against apply on unit vectors
    n = ops.fes.nscalar
    cols = torch.stack([form.apply(data, e)
                        for e in torch.eye(n, dtype=torch.float64)], dim=1)
    torch.testing.assert_close(A, cols, rtol=1e-12, atol=1e-12)
    assert BilinearForm(ops).element_matrices(tasm.OperatorData()) is None


@pytest.mark.parametrize("kind", MESHES)
def test_constrain_dense_matches(kind):
    jops, ops = _pair(kind, order=1)
    jform, form = _cdr_forms(jops, ops)
    ess = ops.fes.boundary_dofs()
    n = ops.fes.nscalar
    jbc, bc = JBC(n, ess), EssentialBC(n, ess, device="cpu")
    jA = jform.dense_matrix(jform.assemble())
    A = form.dense_matrix(form.assemble())
    _close(bc.constrain_dense(A), jbc.constrain_dense(jA))
    _close(bc.constrain_dense(A, diag=3.0), jbc.constrain_dense(jA, diag=3.0))


@pytest.mark.parametrize("kind", MESHES)
def test_boundary_and_supg_linear_forms_match(kind):
    jops, ops = _pair(kind, moved=True)
    dim = ops.fes.mesh.dim
    beta = np.array([1.0, -2.0, 0.5])[:dim]
    _close(tasm.boundary_lf(ops, _smooth), jasm.boundary_lf(jops, _smooth))
    _close(tasm.boundary_lf(ops, 2.0, attr_marker=[1, 3]),
           jasm.boundary_lf(jops, 2.0, attr_marker=[1, 3]))
    v = np.asarray(ops.fes.mesh.vertices) * 1.3
    _close(tasm.boundary_lf(ops, _smooth, attr_marker=[2], vertices=v),
           jasm.boundary_lf(jops, _smooth, attr_marker=[2], vertices=v))
    _close(tasm.boundary_lf(ops, lambda x, t: t * x[:, 0], time=0.5),
           jasm.boundary_lf(jops, lambda x, t: t * x[:, 0], time=0.5))
    _close(tasm.supg_lf(ops, _smooth, beta, 0.05),
           jasm.supg_lf(jops, _smooth, beta, 0.05))
    _close(tasm.domain_lf(ops, _smooth), jasm.domain_lf(jops, _smooth))


@pytest.mark.parametrize("kind", MESHES)
def test_weighted_and_nodal_error_norms_match(kind):
    jops, ops = _pair(kind, moved=True)
    ju, u = _u(ops, 2)
    weight = lambda x: 1.0 + x[:, 0] ** 2
    _close(tasm.weighted_l2_error(ops, u, _smooth, weight),
           jasm.weighted_l2_error(jops, ju, _smooth, weight))
    _close(tasm.weighted_l2_error(ops, u, lambda x, t: t * x[:, 0],
                                  lambda x, t: 1.0 + t * x[:, 0], time=0.3),
           jasm.weighted_l2_error(jops, ju, lambda x, t: t * x[:, 0],
                                  lambda x, t: 1.0 + t * x[:, 0], time=0.3))
    _close(tasm.linf_error(ops.fes, u, _smooth),
           jasm.linf_error(jops.fes, ju, _smooth))
    _close(tasm.linf_error(ops.fes, u, lambda x, t: t * x[:, 0], time=2.0),
           jasm.linf_error(jops.fes, ju, lambda x, t: t * x[:, 0], time=2.0))


# -- the element stage of the element-batched operators, fixed at construction

@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_element_path_takes_the_kernel_where_instantiated(shape):
    for dtype in (torch.float32, torch.float64):
        assert element_path(*shape, "cuda", dtype) == "cuda-btdb"
        assert element_path(*shape, "cuda:1", dtype) == "cuda-btdb"
        assert element_path(*shape, "cpu", dtype) == "plain-btdb"
        assert element_path(*shape, "cuda", dtype,
                            use_kernel=False) == "plain-btdb"
    with pytest.raises(TypeError, match="not supported"):
        element_path(*shape, "cuda", torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        element_path(*shape, "meta", torch.float32)


@pytest.mark.parametrize("shape", [
    (3, 3, 3), (3, 6, 6), (3, 10, 12),   # triangles under no rule of theirs
    (4, 4, 4), (4, 10, 11),              # tets likewise
    (4, 216, 216), (3, 36, 36),          # hexes and quads at order 5
    (4, 27, 125), (3, 9, 25),            # rules with q1 = p + 3
])
def test_element_path_is_plain_elsewhere(shape):
    """A shape no space of the JAX package produces at orders 1-4: a CUDA
    operator is refused in ``btdb_apply``'s words, and the plain version
    runs only on the CPU or where the caller asks for it."""
    with pytest.raises(ValueError, match="not one of"):
        element_path(*shape, "cuda", torch.float32)
    assert element_path(*shape, "cpu", torch.float32) == "plain-btdb"
    assert element_path(*shape, "cuda", torch.float32,
                        use_kernel=False) == "plain-btdb"


@pytest.mark.parametrize("kind,order,quad_order", [
    ("triangle", 1, 2), ("triangle", 3, 6), ("quad", 2, 4),
    ("hex", 4, 11),  # 6 points per axis: (4, 125, 216)
])
def test_pa_operator_path_on_cpu_matches_apply(kind, order, quad_order):
    """On CPU tensors every operator is on the plain path, packs no stream,
    and agrees with ``BilinearForm.apply`` (1e-12 of max|y|); ``path`` is
    read-only.  (Both packages' spaces stop at order 4; order-5 shapes,
    which the kernel does not take, are given as arrays below.)"""
    _, mesh = _meshes(kind) if kind != "hex" \
        else (None, make_cartesian_mesh_3d(1, 2, 1))
    ops = SpaceOps(FESpace(mesh, order), quad_order=quad_order, device="cpu")
    form = BilinearForm(ops).add_mass(1.0).add_diffusion(_smooth)
    data = form.assemble()
    pa = PAOperator(ops, data, dtype=torch.float64)
    assert pa.path == "plain-btdb" and pa.BG_stream is None
    with pytest.raises(AttributeError):
        pa.path = "cuda-btdb"
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        ops.fes.nscalar))
    y, ref = pa(u), form.apply(data, u)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-12
    if kind == "hex":
        spa = StructuredPAOperator(ops, data, StructuredGrid3D(1, 2, 1, order),
                                   dtype=torch.float64)
        assert spa.path == "plain-btdb" and spa.BG_stream is None


def test_pa_operator_from_arrays_at_order_5_shapes_is_plain():
    """(m, nd, nq) = (4, 216, 216), a hex at order 5, given as arrays: the
    plain path on the CPU, and the apply is gather, ``btdb_plain``,
    ``index_add_``."""
    from cmfem_tpu_torch.kernels.btdb import btdb_plain

    rng = np.random.default_rng(5)
    ne, nd, nq, n = 3, 216, 216, 500
    BG, D = rng.standard_normal((4 * nq, nd)), rng.standard_normal((16, nq, ne))
    eldofs = np.stack([rng.permutation(n)[:nd] for _ in range(ne)])
    pa = PAOperator.from_arrays(D, BG, eldofs, n, device="cpu",
                                dtype=torch.float64)
    assert pa.path == "plain-btdb" and pa.BG_stream is None
    u = torch.as_tensor(rng.standard_normal(n))
    y_eT = btdb_plain(pa.BG, u[pa.eldofs_T], pa.Dflat)
    ref = torch.zeros(n, dtype=torch.float64).index_add_(
        0, pa.eldofs_T.reshape(-1), y_eT.reshape(-1))
    torch.testing.assert_close(pa(u), ref, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_pa_operator_paths_agree_with_apply():
    """On the card: triangles, quads, tets and hexes at orders 1-4, under
    p + 1 points per axis and (triangles, hexes) p + 2, go through the kernel
    and move its launch count; with ``use_kernel=False`` they go through the
    plain version and leave the count alone.  Each apply agrees with
    ``BilinearForm.apply`` (float64 1e-12, float32 1e-5 of max|y|).  A shape
    outside ``KERNEL_SHAPES`` is refused by ``btdb_apply`` in its words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.kernels import btdb as kbtdb

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    tri = make_cartesian_mesh_2d(7, 5, geom="triangle")
    quad = make_cartesian_mesh_2d(7, 5)
    hexes = make_cartesian_mesh_3d(3, 4, 5)
    tets = make_tet_mesh(2)
    cases = [(tri, p, 2 * p + 2) for p in (1, 2, 3)]
    cases += [(hexes, 4, 11), (hexes, 2, 7)]
    cases += [(m, p, 2 * p) for m in (tri, quad, tets, hexes)
              for p in (1, 2, 3, 4)]
    for mesh, order, quad_order in cases:
        ops = SpaceOps(FESpace(mesh, order), quad_order=quad_order, device=dev)
        form = BilinearForm(ops).add_mass(1.0).add_diffusion(_smooth)
        data = form.assemble()
        u = torch.as_tensor(rng.standard_normal(ops.fes.nscalar), device=dev)
        ref = form.apply(data, u)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for kernel in (True, False):
                pa = PAOperator(ops, data, dtype=dtype, use_kernel=kernel)
                assert pa.path == ("cuda-btdb" if kernel else "plain-btdb")
                assert (pa.BG_stream is not None) == (
                    (pa.m, pa.BG.shape[1], pa.nq) in kbtdb.TILED_SHAPES
                    and kernel)
                before = kbtdb.launches
                y = pa(u.to(dtype))
                assert kbtdb.launches == before + kernel
                err = float((y.double() - ref).abs().max() / ref.abs().max())
                assert err <= tol, (mesh.geom, order, quad_order, dtype, err)
    ops = SpaceOps(FESpace(hexes, 2), quad_order=7, device=dev)
    data = BilinearForm(ops).add_mass(1.0).assemble()
    grid = StructuredGrid3D(3, 4, 5, 2)
    spa = StructuredPAOperator(ops, data, grid)
    assert spa.path == "cuda-btdb" and spa.BG_stream is not None
    spa = StructuredPAOperator(ops, data, grid, use_kernel=False)
    assert spa.path == "plain-btdb" and spa.BG_stream is None
    BG = torch.zeros((3 * 36, 36), device=dev)
    with pytest.raises(ValueError, match="not one of"):
        kbtdb.btdb_apply(BG, torch.zeros((36, 5), device=dev),
                         torch.zeros((9, 36, 5), device=dev))
