"""B1 for every element shape of the JAX package's spaces (``kernels.btdb.
KERNEL_SHAPES``): the set equals the (m, nd, nq) that the JAX package's
reference elements and Gauss rules give for triangles, quads, tets and
hexes at orders 1-4 under the quadrature orders its forms and drivers use;
the plain version on triangles and tets against the JAX package's
``PAOperator`` (``_xla_btdb``; 1e-12 of max|y|, float64); the indexing of
the kernel's two designs at the new shapes, emulated in numpy (the BG
chunks of the one-thread-per-element design; the tiled design's slabs at
rules with q1 != p + 1); and, on the card (``gpu``), the kernel against its
plain version at every shape, f64 1e-12 and f32 1e-5 of max|y|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_partial_tiles import emulate

from cmfem_tpu_torch.core import (FESpace, make_cartesian_mesh_2d,
                                  make_tet_mesh)
from cmfem_tpu_torch.kernels import btdb as kbtdb
from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
from cmfem_tpu_torch.ops.partial import PAOperator

GEOMS = {"triangle": 3, "quad": 3, "tet": 4, "hex": 4}


def _quad_orders(p):
    """2p (entry, bench, multigrid), 2p + 1 (the default), 2p + 2 (the
    ablation drivers), 2p + 3 (``linear_cd_transient``'s error space), 4."""
    return (2 * p, 2 * p + 1, 2 * p + 2, 2 * p + 3, 4)


def test_kernel_shapes_are_the_jax_spaces_shapes():
    from cmfem_tpu.core.quadrature import gauss_rule
    from cmfem_tpu.core.reference_elements import get_reference_element

    shapes = set()
    for geom, m in GEOMS.items():
        for p in (1, 2, 3, 4):
            ref = get_reference_element(geom, p)
            for qo in _quad_orders(p):
                q = gauss_rule(geom, qo)
                B, _ = ref.eval(q.points)
                shapes.add((m, B.shape[1], len(q.weights)))
    assert shapes == set(kbtdb.KERNEL_SHAPES)
    assert kbtdb.TILED_SHAPES == {s for s in shapes
                                  if s[0] == 4 and s[1] in (27, 64, 125)}


def _meshes(geom):
    if geom == "triangle":
        m = make_cartesian_mesh_2d(3, 2, geom="triangle")
        rng = np.random.default_rng(1)
        return m.with_vertices(m.vertices + 0.03 * rng.standard_normal(
            m.vertices.shape) * (np.abs(m.vertices - 0.5) < 0.49).all(
                axis=1, keepdims=True))
    return make_tet_mesh(1)


def _jax_mesh(m):
    from cmfem_tpu.core.mesh import Mesh as JMesh

    return JMesh(m.dim, m.geom, np.asarray(m.vertices),
                 np.asarray(m.elem_conn), np.asarray(m.elem_attr), m.bdr_geom,
                 np.asarray(m.bdr_conn), np.asarray(m.bdr_attr))


def _kappa(x):
    return 1.0 + x[:, 0] ** 2


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("geom", ["triangle", "tet"])
def test_btdb_plain_matches_jax_pa_operator(geom, p):
    """Each quadrature order of the set: the port's PAOperator (plain on
    the CPU) against the JAX package's on the same mesh and form."""
    from cmfem_tpu.core import FESpace as JFESpace
    from cmfem_tpu.ops import BilinearForm as JBF, SpaceOps as JSO
    from cmfem_tpu.ops.partial import PAOperator as JPA

    mesh = _meshes(geom)
    jmesh = _jax_mesh(mesh)
    beta = np.array([1.0, -2.0, 0.5])[:mesh.dim]
    seen = set()
    for qo in _quad_orders(p):
        ops = SpaceOps(FESpace(mesh, p), quad_order=qo, device="cpu")
        shape = (GEOMS[geom], ops.B.shape[1], ops.B.shape[0])
        if shape in seen:
            continue
        seen.add(shape)
        assert shape in kbtdb.KERNEL_SHAPES
        form = (BilinearForm(ops).add_mass(1.0).add_diffusion(_kappa)
                .add_convection(beta))
        jops = JSO(JFESpace(jmesh, p), quad_order=qo)
        jform = (JBF(jops).add_mass(1.0).add_diffusion(_kappa)
                 .add_convection(beta))
        pa = PAOperator(ops, form.assemble(), dtype=torch.float64)
        jpa = JPA(jops, jform.assemble(), dtype=jnp.float64)
        assert (pa.m, pa.nq) == (jpa.m, jpa.nq) and pa.path == "plain-btdb"
        u = np.random.default_rng(p).standard_normal(ops.fes.nscalar)
        y, y_ref = pa(torch.as_tensor(u)).numpy(), np.asarray(
            jpa(jnp.asarray(u)))
        assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max(), \
            (geom, p, qo)


def _chunked(BG, u_eT, Dflat, itemsize):
    """The one-thread-per-element design with BG staged in chunks of qc
    points (csrc/btdb.cu::launch and btdb_kernel), in numpy."""
    m = int(round(Dflat.shape[0] ** 0.5))
    nq, nd = Dflat.shape[1], u_eT.shape[0]
    per_q = itemsize * m * nd
    qc = min(nq, 48 * 1024 // per_q)
    flatBG = BG.reshape(-1)
    y = np.zeros_like(u_eT)
    for q0 in range(0, nq, qc):
        nc = min(qc, nq - q0)
        sBG = np.full(m * qc * nd, np.nan)
        t = np.arange(m * nc * nd)
        s, r = t // (nc * nd), t % (nc * nd)
        sBG[s * qc * nd + r] = flatBG[(s * nq + q0) * nd + r]
        for j in range(nc):
            q = q0 + j
            rows = [sBG[(s * qc + j) * nd:(s * qc + j + 1) * nd]
                    for s in range(m)]
            U = [row @ u_eT for row in rows]
            for r_ in range(m):
                v = sum(Dflat[r_ * m + s_, q] * U[s_] for s_ in range(m))
                y += np.outer(rows[r_], v)
    return y, qc


@pytest.mark.parametrize("shape", sorted(s for s in kbtdb.KERNEL_SHAPES
                                         if s[1] <= 35))
def test_one_thread_design_chunks_match_plain(shape):
    m, nd, nq = shape
    rng = np.random.default_rng(nd * 1000 + nq)
    BG, u_eT, Dflat = (rng.standard_normal(s) for s in
                       ((m * nq, nd), (nd, 7), (m * m, nq, 7)))
    y_ref = kbtdb.btdb_plain(*map(torch.as_tensor, (BG, u_eT, Dflat)))
    for itemsize in (4, 8):
        y, qc = _chunked(BG, u_eT, Dflat, itemsize)
        assert 1 <= qc <= nq
        assert np.abs(y - y_ref.numpy()).max() \
            <= 1e-12 * np.abs(y_ref.numpy()).max()


@pytest.mark.parametrize("nd,nq", [(27, 64), (64, 27), (64, 125),
                                   (125, 27), (125, 216)])
def test_tiled_design_at_other_rules_matches_plain(nd, nq):
    rng = np.random.default_rng(nd + nq)
    ne = 37
    BG, u_eT, Dflat = (rng.standard_normal(s) for s in
                       ((4 * nq, nd), (nd, ne), (16, nq, ne)))
    y_ref = kbtdb.btdb_plain(*map(torch.as_tensor, (BG, u_eT, Dflat)))
    for itemsize in (4, 8):
        geo = kbtdb.tile_geometry(nd, nq, itemsize)
        assert geo.NSLAB * geo.QC >= nq > (geo.NSLAB - 1) * geo.QC
        y = emulate(BG, u_eT, Dflat, itemsize)
        assert np.abs(y - y_ref.numpy()).max() \
            <= 1e-12 * np.abs(y_ref.numpy()).max()


def test_refusal_names_the_shape():
    with pytest.raises(ValueError, match=r"\(3, 36, 36\) is not one of"):
        kbtdb.require_kernel("cuda", torch.float32, 3, 36, 36)
    for shape in kbtdb.KERNEL_SHAPES:
        kbtdb.require_kernel("cuda", torch.float64, *shape)


@pytest.mark.gpu
def test_cuda_btdb_every_shape_matches_plain():
    """On the card: the kernel at every shape of KERNEL_SHAPES, from
    operators on triangles, quads, tets and hexes (``path ==
    "cuda-btdb"``), against the plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.core import make_cartesian_mesh_3d

    dev = torch.device("cuda")
    meshes = {"triangle": make_cartesian_mesh_2d(5, 4, geom="triangle"),
              "quad": make_cartesian_mesh_2d(5, 4), "tet": make_tet_mesh(2),
              "hex": make_cartesian_mesh_3d(3, 4, 5)}
    seen = set()
    rng = np.random.default_rng(4)
    for geom, mesh in meshes.items():
        for p in (1, 2, 3, 4):
            for qo in _quad_orders(p):
                ops = SpaceOps(FESpace(mesh, p), quad_order=qo, device=dev)
                data = BilinearForm(ops).add_mass(1.0).add_diffusion(
                    _kappa).assemble()
                for dtype, tol in ((torch.float64, 1e-12),
                                   (torch.float32, 1e-5)):
                    pa = PAOperator(ops, data, dtype=dtype)
                    shape = (pa.m, pa.BG.shape[1], pa.nq)
                    assert pa.path == "cuda-btdb" and shape in \
                        kbtdb.KERNEL_SHAPES
                    seen.add(shape)
                    u = torch.as_tensor(rng.standard_normal(
                        pa.eldofs_T.shape), dtype=dtype, device=dev)
                    before = kbtdb.launches
                    yk = kbtdb.btdb_apply(pa.BG, u, pa.Dflat, pa.BG_stream)
                    assert kbtdb.launches == before + 1
                    yp = kbtdb.btdb_plain(pa.BG, u, pa.Dflat)
                    err = float((yk - yp).abs().max() / yp.abs().max())
                    assert err <= tol, (geom, p, qo, dtype, err)
    assert seen == set(kbtdb.KERNEL_SHAPES)
