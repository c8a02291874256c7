"""Port parity, core layer: the numpy copies and the torch geometry of
cmfem_tpu_torch.core equal cmfem_tpu.core on the same inputs.

The copies are the same numpy code, so meshes, DOF maps, node positions,
quadrature rules and B/G tables must be equal exactly; the torch geometric
factors match the JAX ones to 1e-14 (float64, other summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import (
    FESpace as JFESpace,
    gauss_rule as j_gauss_rule,
    get_reference_element as j_ref,
    load_gmsh as j_load_gmsh,
    make_cartesian_mesh_2d as j_mesh2d,
    make_cartesian_mesh_3d as j_mesh3d,
)
from cmfem_tpu.core.geometry import (
    compute_geometric_factors as j_factors,
    compute_geometric_factors_host as j_factors_host,
)
from cmfem_tpu.ops.partial import StructuredGrid3D as JGrid
from cmfem_tpu.ops.sumfact import (
    _axis_matrices as j_axis_matrices,
    _lagrange_tab_1d as j_tab,
)

from cmfem_tpu_torch.core import (
    FESpace,
    gauss_rule,
    get_reference_element,
    load_gmsh,
    make_cartesian_mesh_2d,
    make_cartesian_mesh_3d,
)
from cmfem_tpu_torch.core.geometry import (
    compute_geometric_factors,
    compute_geometric_factors_host,
)
from cmfem_tpu_torch.ops.partial import StructuredGrid3D
from cmfem_tpu_torch.ops.sumfact import _axis_matrices, _lagrange_tab_1d

GEOMS = ["segment", "triangle", "quad", "tet", "hex"]

# two quads sharing an edge, with boundary segments: GMSH v2.2 ASCII
_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
$EndNodes
$Elements
8
1 1 2 1 1 1 2
2 1 2 1 1 2 3
3 1 2 2 2 3 6
4 1 2 3 3 6 5
5 1 2 3 3 5 4
6 1 2 4 4 4 1
7 3 2 7 1 1 2 5 4
8 3 2 7 1 2 3 6 5
$EndElements
"""


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _meshes():
    return {
        "3d-234": (j_mesh3d(2, 3, 4), make_cartesian_mesh_3d(2, 3, 4)),
        "3d-aniso": (j_mesh3d(3, 2, 2, sx=2.0, sz=0.5),
                     make_cartesian_mesh_3d(3, 2, 2, sx=2.0, sz=0.5)),
        "2d-quad": (j_mesh2d(3, 4), make_cartesian_mesh_2d(3, 4)),
        "2d-tri": (j_mesh2d(3, 2, geom="triangle"),
                   make_cartesian_mesh_2d(3, 2, geom="triangle")),
    }


@pytest.mark.parametrize("name", ["3d-234", "3d-aniso", "2d-quad", "2d-tri"])
def test_meshes_equal(name):
    jm, m = _meshes()[name]
    for f in ("dim", "geom", "bdr_geom"):
        assert getattr(jm, f) == getattr(m, f)
    for f in ("vertices", "elem_conn", "elem_attr", "bdr_conn", "bdr_attr"):
        _eq(getattr(jm, f), getattr(m, f))
    jr, r = jm.uniform_refine(1), m.uniform_refine(1)
    _eq(jr.vertices, r.vertices)
    _eq(jr.elem_conn, r.elem_conn)


def test_load_gmsh_equal():
    jm = j_load_gmsh(_MSH)
    m = load_gmsh(_MSH)
    assert (jm.dim, jm.geom, jm.bdr_geom) == (m.dim, m.geom, m.bdr_geom)
    for f in ("vertices", "elem_conn", "elem_attr", "bdr_conn", "bdr_attr"):
        _eq(getattr(jm, f), getattr(m, f))


@pytest.mark.parametrize("name,order", [("3d-234", 1), ("3d-234", 2),
                                        ("3d-aniso", 3), ("2d-quad", 2),
                                        ("2d-tri", 3)])
def test_fespace_equal(name, order):
    jm, m = _meshes()[name]
    jf, f = JFESpace(jm, order), FESpace(m, order)
    assert jf.nscalar == f.nscalar
    _eq(jf.element_dofs, f.element_dofs)
    _eq(jf.node_positions, f.node_positions)
    _eq(jf.boundary_dofs(), f.boundary_dofs())
    _eq(jf.boundary_dofs([1, 3]), f.boundary_dofs([1, 3]))
    _eq(jf.bdr.dofs, f.bdr.dofs)


@pytest.mark.parametrize("geom", GEOMS)
def test_quadrature_and_tables_equal(geom):
    for order in range(0, 9):
        jq, q = j_gauss_rule(geom, order), gauss_rule(geom, order)
        _eq(jq.points, q.points)
        _eq(jq.weights, q.weights)
    for p in (1, 2, 3):
        q = gauss_rule(geom, 2 * p)
        jB, jG = j_ref(geom, p).eval(q.points)
        B, G = get_reference_element(geom, p).eval(q.points)
        _eq(jB, B)
        _eq(jG, G)
        _eq(j_ref(geom, p).nodes, get_reference_element(geom, p).nodes)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_sumfact_1d_tables_equal(p):
    for a, b in zip(j_tab(p, p + 1), _lagrange_tab_1d(p, p + 1)):
        _eq(a, b)
    for a, b in zip(j_axis_matrices(3, p, p + 1), _axis_matrices(3, p, p + 1)):
        _eq(a, b)


@pytest.mark.parametrize("order", [1, 2])
def test_geometric_factors_match(order):
    rng = np.random.default_rng(3)
    jm = j_mesh3d(2, 2, 3)
    verts = jm.vertices + 0.05 * rng.standard_normal(jm.vertices.shape)
    coords = verts[jm.elem_conn]
    q = gauss_rule("hex", 2 * order)
    Bg, Gg = get_reference_element("hex", 1).eval(q.points)
    jh = j_factors_host(coords, Bg, Gg, q.weights)
    h = compute_geometric_factors_host(coords, Bg, Gg, q.weights)
    jt = j_factors(jnp.asarray(coords), Bg, Gg, q.weights)
    t = compute_geometric_factors(torch.as_tensor(coords), Bg, Gg, q.weights)
    for f in ("detJ", "invJ", "wdetJ", "xq"):
        _eq(getattr(jh, f), getattr(h, f))
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(jt, f)),
                                   rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_structured_grid_equal(p):
    jg, g = JGrid(3, 2, 4, p), StructuredGrid3D(3, 2, 4, p)
    assert (jg.NX, jg.NY, jg.NZ, jg.ndofs) == (g.NX, g.NY, g.NZ, g.ndofs)
    _eq(jg.local_perm, g.local_perm)
    _eq(jg.boundary_mask(), g.boundary_mask())
    _eq(jg.node_positions(), g.node_positions())
    rng = np.random.default_rng(p)
    u = rng.standard_normal(g.ndofs)
    ue = g.gather(torch.as_tensor(u))
    _eq(np.asarray(jg.gather(jnp.asarray(u))), ue.numpy())
    ye = rng.standard_normal(tuple(ue.shape))
    np.testing.assert_allclose(g.scatter(torch.as_tensor(ye)).numpy(),
                               np.asarray(jg.scatter(jnp.asarray(ye))),
                               rtol=1e-15, atol=1e-15)
