"""Port parity, ``parallel/partition.py`` and ``parallel/sharding.py``: the
RCB partition (native and numpy routes) against the JAX package's, and
``ShardedPoissonApply`` on gloo worlds of 2 and 4 CPU ranks against JAX's
on as many virtual devices (apply 1e-11, Jacobi-CG with equal iteration
counts and x to 1e-10), float64; ``entry.dryrun_multichip(2)`` on CPU
ranks.  One spawn per world size (``torch_dist_helpers``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_helpers as H
from cmfem_tpu_torch.core import make_cartesian_mesh_2d, make_cartesian_mesh_3d
from cmfem_tpu_torch.parallel import spawn_ranks
from cmfem_tpu_torch.parallel import partition as P


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    """(world size, the ranks' records) of one spawn."""
    n = request.param
    return n, spawn_ranks(H.sharding_checks, n, (n,), timeout=180)


@pytest.fixture(scope="module")
def jax_problem():
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d as jmesh
    from cmfem_tpu.ops import BilinearForm, EssentialBC, SpaceOps

    fes = FESpace(jmesh(3, 3, 3), 2)
    ops = SpaceOps(fes, quad_order=4)
    cdr = (BilinearForm(ops).add_diffusion(0.3).add_mass(1.0)
           .add_convection(H.BETA))
    spd = BilinearForm(ops).add_diffusion(1.0).add_mass(0.5)
    bc = EssentialBC(fes.nscalar, fes.boundary_dofs())
    return fes, ops, cdr, spd, bc


@pytest.mark.parametrize("kind,nparts", [
    ("hex", 2), ("hex", 4), ("hex", 8), ("hex", 5), ("quad", 3),
    ("tri", 4), ("quad", 16)])
def test_partition_elements_matches_jax(kind, nparts):
    from cmfem_tpu.core.mesh import Mesh as JMesh
    from cmfem_tpu.parallel.partition import partition_elements as jpe

    m = {"hex": lambda: make_cartesian_mesh_3d(5, 4, 3),
         "quad": lambda: make_cartesian_mesh_2d(2, 2) if nparts == 16
         else make_cartesian_mesh_2d(7, 5),
         "tri": lambda: make_cartesian_mesh_2d(6, 6, geom="triangle")}[kind]()
    jm = JMesh(m.dim, m.geom, np.asarray(m.vertices), np.asarray(m.elem_conn),
               np.asarray(m.elem_attr), m.bdr_geom, np.asarray(m.bdr_conn),
               np.asarray(m.bdr_attr))
    from cmfem_tpu.parallel.partition import _rcb_numpy as j_rcb_numpy

    parts = P.partition_elements(m, nparts)
    np.testing.assert_array_equal(parts, jpe(jm, nparts))
    assert parts.min() >= 0 and parts.max() < nparts
    # each route of the port equals the JAX package's: numpy with numpy;
    # the native RCB (where the library loads) equals numpy where no two
    # centroids tie on a cut axis (the routes break ties differently)
    centroids = np.asarray(m.vertices)[m.elem_conn].mean(axis=1)
    np.testing.assert_array_equal(P._rcb_numpy(centroids, nparts),
                                  j_rcb_numpy(centroids, nparts))
    jitter = centroids + 1e-3 * np.random.default_rng(nparts).random(
        centroids.shape)
    from cmfem_tpu_torch.native import rcb_partition_native

    native = rcb_partition_native(jitter, nparts)
    if native is not None:
        np.testing.assert_array_equal(native, P._rcb_numpy(jitter, nparts))
    np.testing.assert_array_equal(
        P.partition_elements(m, nparts, method="contiguous"),
        jpe(jm, nparts, method="contiguous"))


def test_partition_permutation_and_refusals():
    from cmfem_tpu.parallel.partition import partition_permutation as jpp

    m = make_cartesian_mesh_2d(2, 2)
    parts = P.partition_elements(m, 16)
    perm, counts = P.partition_permutation(parts, nparts=16)
    jperm, jcounts = jpp(parts, nparts=16)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(counts, jcounts)
    assert len(counts) == 16 and counts.sum() == 4
    perm0, counts0 = P.partition_permutation(np.array([0, 0, 1]))
    assert list(counts0) == [2, 1] and list(perm0) == [0, 1, 2]
    assert (P.partition_elements(m, 1) == 0).all()
    with pytest.raises(ValueError, match="Unknown partition method"):
        P.partition_elements(m, 2, method="metis")


def test_sharded_apply_matches_jax(world, jax_problem):
    from cmfem_tpu.parallel import ShardedPoissonApply, make_device_mesh

    n, ranks = world
    fes, ops, cdr, _, _ = jax_problem
    data = cdr.assemble()
    u = jnp.asarray(np.random.default_rng(0).standard_normal(fes.nscalar))
    y_jax = np.asarray(ShardedPoissonApply(ops, data, make_device_mesh(n))(u))
    y_ref = np.asarray(cdr.apply(data, u))
    ne = fes.mesh.num_elements
    for rec in ranks:
        assert rec["ne_pad"] == -(-ne // n) * n
        np.testing.assert_allclose(rec["y"], y_jax, rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(rec["y"], y_ref, rtol=1e-11, atol=1e-11)
    # every rank holds the same replicated product
    for rec in ranks[1:]:
        np.testing.assert_array_equal(rec["y"], ranks[0]["y"])
    # a mesh larger or smaller than the world is refused on every rank
    for rec in ranks:
        assert len(rec["refusals"]) == 2, rec["refusals"]
        assert f"only {n} exist" in rec["refusals"][0]
        assert "part of the world" in rec["refusals"][1]


def test_sharded_cg_matches_jax(world, jax_problem):
    from cmfem_tpu.parallel import ShardedPoissonApply, make_device_mesh
    from cmfem_tpu.solvers import cg, jacobi_preconditioner

    n, ranks = world
    fes, ops, _, spd, bc = jax_problem
    data = spd.assemble()
    A = ShardedPoissonApply(ops, data, make_device_mesh(n))
    b = jnp.asarray(np.random.default_rng(1).standard_normal(fes.nscalar))
    b = jnp.where(bc.mask, 0.0, b)
    M = jacobi_preconditioner(jnp.where(bc.mask, 1.0,
                                        spd.assemble_diagonal(data)))
    r_jax = cg(bc.constrain_operator(lambda v: A(v)), b, M=M, rtol=1e-12,
               maxiter=500)
    for rec in ranks:
        assert rec["iters"] == int(r_jax.iters)
        np.testing.assert_allclose(rec["x"], np.asarray(r_jax.x), rtol=0,
                                   atol=1e-10)


def test_shard_elements_pads_with_zeros():
    """One rank (no spawn): the slab of a world of 1 is the whole array,
    in the mesh's device, no padding."""
    from cmfem_tpu_torch.parallel import DeviceMesh, shard_elements

    mesh = DeviceMesh(0, 1, torch.device("cpu"), None)
    a = np.arange(12.0).reshape(6, 2)
    (out,), ne_pad = shard_elements(mesh, a)
    assert ne_pad == 6 and torch.equal(out, torch.as_tensor(a))
    mesh4 = DeviceMesh(3, 4, torch.device("cpu"), None)
    (out,), ne_pad = shard_elements(mesh4, a)
    assert ne_pad == 8 and out.shape == (2, 2) and not out.any()


@pytest.mark.parametrize("present", [
    ("d00", "d01", "d10", "d11"), ("d00",), ("d11",), ("d10", "d11"),
    ("d00", "d01")])
def test_qp_block_apply_matches_jax(present):
    """The element stage shared by ``BilinearForm.apply`` and the
    element-split operators against the JAX package's ``qp_block_apply``
    (float64, 1e-12 of max|y|), with some of the QP blocks absent; and
    ``BilinearForm.apply`` is that stage scattered."""
    from cmfem_tpu.parallel.sharding import qp_block_apply as jqp
    from cmfem_tpu_torch.ops import assembly as tasm
    from cmfem_tpu_torch.parallel import sharding as tsh

    assert tsh.qp_block_apply is tasm.qp_block_apply
    rng = np.random.default_rng(len(present))
    ne, nq, nd, dim = 7, 9, 6, 2
    shapes = {"d00": (ne, nq), "d01": (ne, nq, dim), "d10": (ne, nq, dim),
              "d11": (ne, nq, dim, dim)}
    arrays = [rng.standard_normal(s) for s in
              ((nq, nd), (nq, nd, dim), (ne, nd))]
    blocks = [rng.standard_normal(shapes[k]) if k in present else None
              for k in ("d00", "d01", "d10", "d11")]
    y = tasm.qp_block_apply(*[None if a is None else torch.as_tensor(a)
                              for a in arrays + blocks])
    want = np.asarray(jqp(*[None if a is None else jnp.asarray(a)
                            for a in arrays + blocks]))
    assert float(np.abs(y.numpy() - want).max()) \
        <= 1e-12 * np.abs(want).max()

    from cmfem_tpu_torch.ops import BilinearForm, SpaceOps
    from cmfem_tpu_torch.core import FESpace

    ops = SpaceOps(FESpace(make_cartesian_mesh_2d(3, 2), 2), device="cpu")
    form = (BilinearForm(ops).add_mass(1.0).add_diffusion(0.5)
            .add_convection((1.0, -0.5)))
    data = form.assemble()
    u = torch.as_tensor(rng.standard_normal(ops.fes.nscalar))
    y_e = tasm.qp_block_apply(ops.B, ops.G, u[ops.eldofs], data.d00,
                              data.d01, data.d10, data.d11)
    assert torch.equal(form.apply(data, u), ops.scatter(y_e))


def test_make_device_mesh_refusals():
    from cmfem_tpu_torch.parallel import make_device_mesh

    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        make_device_mesh(2, device="cpu")


def test_dryrun_multichip_on_two_cpu_ranks():
    from cmfem_tpu_torch.entry import dryrun_multichip

    recs = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in recs] == [0, 1]
    for r in recs:
        assert r["size"] == 2 and r["device"] == "cpu"
        assert r["dofpart_rel"] < 1e-3 and r["sumfact_rel"] < 1e-5
        assert r["per_device_floats"] < r["ndofs"]
        assert np.isfinite(r["step_norm"])
        # the ablation sections (dryrun_ablation_rank)
        assert r["ablation_sharded_r1"] < r["ablation_sharded_r0"]
        assert r["ablation_dofpart_rel"] < 1e-6
        assert r["ablation_case22_rel"] < 1e-6
        assert r["ablation_case22_r0_rel"] <= 1e-6
    assert recs[0]["step_norm"] == recs[1]["step_norm"]
    assert recs[0]["ablation_sharded_r1"] == recs[1]["ablation_sharded_r1"]


def test_dryrun_ablation_sections_on_four_cpu_ranks():
    """The ablation sections alone (``entry.dryrun_ablation_rank``) on four
    gloo ranks, where the DOF-partitioned layout is smaller than the
    replicated vectors."""
    from cmfem_tpu_torch.entry import dryrun_ablation_rank
    from cmfem_tpu_torch.parallel import spawn_ranks

    recs = spawn_ranks(dryrun_ablation_rank, 4, (4, "cpu"), timeout=120)
    for r in recs:
        assert r["ablation_per_device_floats"] < r["ablation_dofs"]
        assert r["ablation_dofpart_rel"] < 1e-6
        assert r["ablation_case22_rel"] < 1e-6
        assert r == recs[0]


@pytest.mark.gpu
def test_cuda_dryrun_multichip_one_nccl_rank():
    """On the card: one NCCL rank, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.entry import dryrun_multichip

    (rec,) = dryrun_multichip(1)
    assert rec["device"].startswith("cuda") and rec["size"] == 1
    assert rec["pa_path"] == "cuda-btdb"
    assert rec["dofpart_rel"] < 1e-3 and rec["sumfact_rel"] < 1e-5
    assert rec["dofpart_iters"] == rec["single_iters"]
    assert rec["ablation_dofpart_rel"] < 1e-6
    assert rec["ablation_case22_rel"] < 1e-6
