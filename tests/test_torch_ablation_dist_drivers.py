"""The ablation drivers' ``sharding_devices: N`` and ``dof_partition: N``
(``apps.distributed``): cases 1, 2.1 and 2.2 on a 3 x 20 strip (2.2 on
triangles, the mesh receding from step 1) with the synthetic deck and
schedule, 2 steps of dt 0.1, each option on a gloo world of 2 CPU ranks
(every rank runs the host loop, the Newton iterate distributed) against
the port's host-LU run (itself held to the JAX drivers to 1e-7 by the
drivers' own test files): T to 1e-6 and p to 1e-8 relative (the JAX
package's driver tolerances, ``tests/test_dofpart.py``), the same Newton
counts, 2.2's vertices to 1e-9 relative; rank 0 writes every CSV once.
One world of one rank runs in this process (``dof_partition: 1``)."""

import os

import numpy as np
import pytest

from torch_ablation_helpers import (  # noqa: F401
    FIXTURE, SCHED, TOP, case22_cfg, newton_counts, one_torch_thread,
    strip_file)

DRIVERS = ("ablation_case1", "ablation_case2_1", "ablation_case2_2")
OPTIONS = ("sharding_devices", "dof_partition")
NEWTON_CSV = {d: f"newton_history_{d}_2D.csv" for d in DRIVERS}


def _cfg(driver, strips, out):
    if driver == "ablation_case2_2":
        cfg = case22_cfg(strips["triangle"], out)
        cfg.update(t_final=0.2, output_every=1)
        return cfg
    cfg = {"mesh_file": strips["quad"], "material_file": FIXTURE,
           "order": 1, "dt": 0.1, "t_final": 0.2, "bdr_attr_top": TOP,
           "probe_x": 0.00125, "newton_print_level": 0,
           "save_paraview": False, "output_every": 1, "output_path": out}
    if driver == "ablation_case2_1":
        cfg["boundary_conditions_file"] = SCHED
    return cfg


@pytest.fixture(scope="module")
def strips(tmp_path_factory):
    d = tmp_path_factory.mktemp("strips")
    return {g: strip_file(d, 3, 20, geom=g) for g in ("quad", "triangle")}


@pytest.fixture(scope="module")
def lu_runs(strips, tmp_path_factory):
    import importlib

    out = {}
    for d in DRIVERS:
        path = tmp_path_factory.mktemp(f"{d}_lu")
        run = importlib.import_module(f"cmfem_tpu_torch.apps.{d}").run
        out[d] = (run(_cfg(d, strips, str(path)), device="cpu"), path)
    return out


def _hold(got, ref):
    for f, tol in (("T", 1e-6), ("p", 1e-8)):
        d = np.abs(got[f] - ref[f]).max() / np.abs(ref[f]).max()
        assert d <= tol, (f, d)
    assert got["newton_iters"] == ref["newton_iters"]
    if "vertices" in ref:
        v = np.abs(got["vertices"] - ref["vertices"]).max()
        assert v <= 1e-9 * np.abs(ref["vertices"]).max(), v
        assert got["recession_total"] == pytest.approx(
            ref["recession_total"], rel=1e-9)


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_option_on_two_ranks_matches_host_lu(strips, lu_runs,
                                                    tmp_path, driver,
                                                    option):
    import importlib

    run = importlib.import_module(f"cmfem_tpu_torch.apps.{driver}").run
    cfg = {**_cfg(driver, strips, str(tmp_path)), option: 2}
    got = run(cfg, device="cpu")
    ref, ref_dir = lu_runs[driver]
    _hold(got, ref)
    # one GMRES solve per Newton update, recorded on the rank
    assert [len(k) for k in got["krylov_iters"]] == got["newton_iters"]
    # rank 0 wrote each file of the host-LU run, once: its header and
    # as many lines
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(tmp_path)) == names
    for name in names:
        a, b = ((d / name).read_text().splitlines()
                for d in (tmp_path, ref_dir))
        assert a[0] == b[0] and len(a) == len(b), name
    assert newton_counts(tmp_path / NEWTON_CSV[driver]) == \
        ref["newton_iters"]


def test_one_rank_runs_in_this_process(strips, lu_runs, tmp_path):
    import torch.distributed as dist

    from cmfem_tpu_torch.apps import ablation_case1

    cfg = {**_cfg("ablation_case1", strips, str(tmp_path)),
           "dof_partition": 1}
    _hold(ablation_case1.run(cfg, device="cpu"),
          lu_runs["ablation_case1"][0])
    assert not dist.is_initialized()


@pytest.mark.gpu
@pytest.mark.parametrize("driver,option", [
    ("ablation_case1", "dof_partition"),
    ("ablation_case2_2", "sharding_devices")])
def test_cuda_one_nccl_rank_matches_host_lu(strips, lu_runs, tmp_path,
                                            driver, option):
    """On the card: the option with one NCCL rank in this process, held to
    the CPU host-LU run."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = importlib.import_module(f"cmfem_tpu_torch.apps.{driver}").run
    got = run({**_cfg(driver, strips, str(tmp_path)), option: 1})
    _hold(got, lu_runs[driver][0])
