"""Port parity, ``ops.faces.BoundaryTrace``: the same meshes (numpy arrays
given to both packages' ``Mesh``) through the JAX trace and the port's, float64
on the CPU: equal ``combo`` arrays (the orientation matching is numpy in
both), and ``values``, ``grads``, ``scatter``, ``element_invJ`` and
``face_factors`` to 1e-12 of the largest entry.  Cases as in
``tests/test_faces3d.py``: quads and triangles (2D edges, vertices moved),
hexes at orders 1-3 (boundary cycles rolled and reversed at random), tets at
orders 1-3 (two tets refined once; one tet with rolled and reversed faces),
with and without an attribute marker; plus the port's own checks of exactness
on a linear field, the cube's area, outward normals and the scatter as the
adjoint of ``values``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace
from cmfem_tpu.core.mesh import Mesh as JMesh
from cmfem_tpu.ops import SpaceOps as JSpaceOps
from cmfem_tpu.ops.faces import BoundaryTrace as JTrace

from cmfem_tpu_torch.core import (
    FESpace, make_cartesian_mesh_2d, make_cartesian_mesh_3d,
)
from cmfem_tpu_torch.core.mesh import Mesh
from cmfem_tpu_torch.core.reference_elements import (
    GEOM_FACES, TETRAHEDRON, TRIANGLE,
)
from cmfem_tpu_torch.ops import SpaceOps
from cmfem_tpu_torch.ops.faces import BoundaryTrace


def _linear(pts):
    out = pts[..., 0] + 2.0 * pts[..., 1]
    return out + 3.0 * pts[..., 2] if pts.shape[-1] == 3 else out


def _fields(m):
    return dict(dim=m.dim, geom=m.geom, vertices=np.asarray(m.vertices),
                elem_conn=np.asarray(m.elem_conn),
                elem_attr=np.asarray(m.elem_attr), bdr_geom=m.bdr_geom,
                bdr_conn=np.asarray(m.bdr_conn),
                bdr_attr=np.asarray(m.bdr_attr))


def _tets(kind):
    if kind == "tet1":  # one tet, faces rolled and reversed
        verts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        faces = []
        for i, f in enumerate(GEOM_FACES[TETRAHEDRON]):
            c = np.roll(np.asarray(f), (0, 1, 2, 0)[i])
            faces.append(c[::-1] if i in (1, 3) else c)
        return Mesh(dim=3, geom=TETRAHEDRON, vertices=verts,
                    elem_conn=np.array([[0, 1, 2, 3]], dtype=np.int32),
                    elem_attr=np.ones(1, dtype=np.int32), bdr_geom=TRIANGLE,
                    bdr_conn=np.asarray(faces, dtype=np.int32),
                    bdr_attr=np.arange(1, 5, dtype=np.int32))
    verts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0], [1.0, 1.0, 1.0]])
    conn = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], dtype=np.int32)
    faces = [tuple(int(e[i]) for i in f) for e in conn
             for f in GEOM_FACES[TETRAHEDRON]]
    faces = [f for f in faces if set(f) != {1, 2, 3}]  # the shared face
    m = Mesh(dim=3, geom=TETRAHEDRON, vertices=verts, elem_conn=conn,
             elem_attr=np.ones(2, dtype=np.int32), bdr_geom=TRIANGLE,
             bdr_conn=np.asarray(faces, dtype=np.int32),
             bdr_attr=np.array([1, 2, 3, 1, 2, 3], dtype=np.int32))
    return m.uniform_refine(1)


def _mesh(kind):
    rng = np.random.default_rng(5)
    if kind in ("quad", "triangle"):
        m = make_cartesian_mesh_2d(3, 4, geom=kind)
        return m.with_vertices(
            m.vertices + 0.03 * rng.standard_normal(m.vertices.shape))
    if kind == "hex":
        m = make_cartesian_mesh_3d(2, 2, 3)
        conn = np.asarray(m.bdr_conn).copy()
        for i in range(len(conn)):
            conn[i] = np.roll(conn[i], int(rng.integers(0, 4)))
            if rng.random() < 0.5:
                conn[i] = conn[i][::-1]
        f = _fields(m)
        f["bdr_conn"] = conn.astype(np.int32)
        f["vertices"] = m.vertices + 0.02 * rng.standard_normal(
            m.vertices.shape)
        return Mesh(**f)
    return _tets(kind)


def _pair(kind, order, attr_marker=None):
    m = _mesh(kind)
    jm = JMesh(**_fields(m))
    q = 2 * order
    jtr = JTrace(JSpaceOps(JFESpace(jm, order), quad_order=q),
                 attr_marker=attr_marker)
    tr = BoundaryTrace(SpaceOps(FESpace(m, order), quad_order=q, device="cpu"),
                       attr_marker=attr_marker)
    return jtr, tr


def _close(t, j):
    j = np.asarray(j)
    assert t.dtype == torch.float64 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(j).max()))


CASES = ([("quad", p, None) for p in (1, 2, 3)]
         + [("triangle", p, None) for p in (1, 2, 3)]
         + [("quad", 2, [1, 2]), ("triangle", 3, [3])]
         + [("hex", p, None) for p in (1, 2, 3)] + [("hex", 2, [2, 5])]
         + [("tet2", p, None) for p in (1, 2, 3)] + [("tet2", 2, [2])]
         + [("tet1", p, None) for p in (1, 2, 3)])


@pytest.mark.parametrize("kind,order,marker", CASES,
                         ids=[f"{k}-p{p}{'-marked' if m else ''}"
                              for k, p, m in CASES])
def test_trace_matches_jax(kind, order, marker):
    jtr, tr = _pair(kind, order, marker)
    assert tr.nbf == jtr.nbf > 0
    np.testing.assert_array_equal(tr.combo, jtr.combo)
    np.testing.assert_array_equal(tr.face_ids, jtr.face_ids)
    rng = np.random.default_rng(order)
    n = tr.fes.nscalar
    u = rng.standard_normal(n)
    r = rng.standard_normal((tr.nbf, len(tr.quad.weights)))
    _close(tr.values(torch.as_tensor(u)), jtr.values(jnp.asarray(u)))
    _close(tr.grads(torch.as_tensor(u)), jtr.grads(jnp.asarray(u)))
    _close(tr.scatter(torch.as_tensor(r)), jtr.scatter(jnp.asarray(r)))
    _close(tr.element_invJ(), jtr.element_invJ())
    ff, jff = tr.face_factors(), jtr.face_factors()
    for name in ("wdS", "normal", "xq"):
        _close(getattr(ff, name), getattr(jff, name))
    # moved vertices (a tensor) reach the factors and the gradients alike
    v = tr.fes.mesh.vertices * 1.1
    _close(tr.face_factors(torch.as_tensor(v)).wdS,
           jtr.face_factors(jnp.asarray(v)).wdS)
    _close(tr.grads(torch.as_tensor(u), torch.as_tensor(v)),
           jtr.grads(jnp.asarray(u), jnp.asarray(v)))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_hex_trace_linear_field_area_normals(order):
    fes = FESpace(make_cartesian_mesh_3d(2, 2, 2), order)
    tr = BoundaryTrace(SpaceOps(fes, quad_order=2 * order, device="cpu"))
    u = torch.as_tensor(fes.interpolate(_linear))
    ff = tr.face_factors()
    assert abs(float(ff.wdS.sum()) - 6.0) < 1e-12
    torch.testing.assert_close(tr.values(u), _linear(ff.xq), rtol=0,
                               atol=1e-12)
    g = tr.grads(u)
    torch.testing.assert_close(
        g, torch.tensor([1.0, 2.0, 3.0], dtype=g.dtype).expand_as(g),
        rtol=0, atol=1e-10)
    assert (torch.einsum("fqd,fqd->fq", ff.normal, ff.xq - 0.5) > 0).all()


@pytest.mark.parametrize("kind", ["quad", "hex", "tet2"])
def test_scatter_is_adjoint_of_values(kind):
    fes = FESpace(_mesh(kind), 2)
    tr = BoundaryTrace(SpaceOps(fes, quad_order=4, device="cpu"))
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(fes.nscalar))
    r = torch.as_tensor(rng.standard_normal((tr.nbf, len(tr.quad.weights))))
    lhs = float(torch.sum(r * tr.values(u)))
    rhs = float(torch.dot(tr.scatter(r), u))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_unmatched_face_is_refused():
    fes = FESpace(make_cartesian_mesh_2d(2, 2), 1)
    elem = np.asarray(fes.bdr.elem).copy()
    assert elem[0] == 0  # face 0 is the edge (0, 1) of element 0
    elem[0] = 3          # the opposite corner's element does not hold it
    fes.bdr.elem = elem
    with pytest.raises(ValueError, match="not matched"):
        BoundaryTrace(SpaceOps(fes, device="cpu"))
