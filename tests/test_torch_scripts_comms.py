"""Port, ``cmfem_tpu_torch.scripts.comms_model`` on 2 and 4 gloo ranks (one
spawn per world size): the z-sharded sum-factorized apply exchanges one
(NYd, NXd) plane each way per neighbouring pair, 2 * NXd * NYd * itemsize
per pair and apply (an end rank one send and one receive, an interior rank
two of each), with no set-up traffic; the DOF-partitioned CG makes 6
all_reduces per iteration, two interface halos of n_interface + 1 floats
and four scalar dots, the same on every rank, and 8 outside the loop; the
interface size is the JAX package's ``DofPartition``'s on the same mesh;
and ``CollectiveLog`` leaves ``torch.distributed`` as it found it; ``main``
runs only when the CPU is asked for."""

import json

import numpy as np
import pytest
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d

from cmfem_tpu_torch.scripts import comms_model


@pytest.fixture(scope="module", params=[2, 4])
def model(request):
    return comms_model.model(request.param)


def test_sumfact_halo_bytes(model):
    n = model["n_devices"]
    sf = model["z_sharded_sumfact"]
    plane = 17 * 17 * 4
    assert sf["analytic_halo_bytes_per_apply"] == 2 * plane
    assert sf["halo_bytes_per_apply_per_pair"] == 2 * plane
    assert sf["sent_bytes_per_apply_by_rank"] == \
        [plane] + [2 * plane] * (n - 2) + [plane]
    assert sf["per_apply_by_rank"] == [2] + [4] * (n - 2) + [2]
    assert sf["per_call_bytes"] == 0
    assert sf["ops_rank0"] == {"irecv float32[17, 17]": 1.0,
                               "isend float32[17, 17]": 1.0}


def test_dofpart_cg_per_iteration(model):
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.parallel.dofpart import DofPartition

    n = model["n_devices"]
    dp = model["dofpart_cg"]
    nif = dp["n_interface"]
    assert dp["per_iteration_count"] == 6
    assert dp["per_iteration_bytes"] == (2 * (nif + 1) + 4) * 4 \
        == dp["expected_per_iteration_bytes"]
    assert dp["ops"] == {f"all_reduce float32[{nif + 1}]": 2.0,
                         "all_reduce float32[]": 4.0}
    assert dp["per_call_count"] == 8 and dp["same_on_every_rank"]
    fes = FESpace(make_cartesian_mesh_2d(22, 22, geom="triangle"), 2)
    assert dp["ndofs"] == fes.nscalar
    jp = DofPartition(np.asarray(fes.element_dofs), fes.nscalar, n,
                      mesh=fes.mesh)
    assert nif == jp.n_interface
    assert dp["per_device_floats"] == jp.nown_max + jp.nghost_max


def test_collective_log_restores_torch_distributed():
    before = {k: getattr(dist, k) for k in comms_model.CollectiveLog.WRAPPED}
    with comms_model.CollectiveLog() as log:
        assert dist.all_reduce is not before["all_reduce"]
        assert c10d.isend is dist.isend
    assert log.records == []
    for k, fn in before.items():
        assert getattr(dist, k) is fn and getattr(c10d, k) is fn


def test_main_runs_on_the_cpu_only_when_asked(monkeypatch, tmp_path):
    """``main`` refuses to run without --cpu (or CMFEM_FORCE_CPU=1), and
    with it writes its artifact under --out-dir."""
    monkeypatch.delenv("CMFEM_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="gloo CPU ranks"):
        comms_model.main(["2", "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    assert comms_model.main(["2", "--cpu", "--out-dir", str(tmp_path)]) == 0
    with open(tmp_path / "comms_model.json") as f:
        art = json.load(f)
    assert [m["n_devices"] for m in art["by_world_size"]] == [2]
