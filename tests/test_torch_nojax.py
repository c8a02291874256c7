"""The port stands alone: no module of cmfem_tpu_torch (nor chip_smoke.py)
imports jax, the JAX package or the repo's scripts/, and chip_smoke.py
refuses to run without a GPU or without the package beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import cmfem_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cmfem_tpu_torch.__path__, prefix="cmfem_tpu_torch."))


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"cmfem_tpu_torch.entry", "cmfem_tpu_torch.interop",
            "cmfem_tpu_torch.kernels.sumfact", "cmfem_tpu_torch.ops.sumfact",
            "cmfem_tpu_torch.solvers.krylov", "cmfem_tpu_torch.kernels.btdb",
            "cmfem_tpu_torch.ops.partial",
            "cmfem_tpu_torch.solvers.multigrid",
            "cmfem_tpu_torch.kernels.zchain",
            "cmfem_tpu_torch.core.pointlocate", "cmfem_tpu_torch.native",
            "cmfem_tpu_torch.solvers.direct",
            "cmfem_tpu_torch.solvers.timeint",
            "cmfem_tpu_torch.solvers.newton",
            "cmfem_tpu_torch.utils.yamlcfg", "cmfem_tpu_torch.utils.timing",
            "cmfem_tpu_torch.io.csvio", "cmfem_tpu_torch.io.vtu",
            "cmfem_tpu_torch.apps.common",
            "cmfem_tpu_torch.apps.diffusion_mms",
            "cmfem_tpu_torch.apps.linear_cd_2d",
            "cmfem_tpu_torch.apps.linear_cd_2d_circle",
            "cmfem_tpu_torch.apps.linear_cd_transient",
            "cmfem_tpu_torch.physics.exact_solutions",
            "cmfem_tpu_torch.ops.nonlinear", "cmfem_tpu_torch.ops.faces",
            "cmfem_tpu_torch.ops.vector", "cmfem_tpu_torch.motion.ale",
            "cmfem_tpu_torch.apps.nonlinear_diffusion",
            "cmfem_tpu_torch.apps.elasticity",
            "cmfem_tpu_torch.apps.diffusion_mms_ale",
            "cmfem_tpu_torch.apps.qstar_blowing_1d",
            "cmfem_tpu_torch.physics.tacot", "cmfem_tpu_torch.physics.ablation",
            "cmfem_tpu_torch.ops.lattice2d",
            "cmfem_tpu_torch.solvers.blocksolve",
            "cmfem_tpu_torch.apps.ablation_case1",
            "cmfem_tpu_torch.apps.ablation_loop",
            "cmfem_tpu_torch.physics.surface_bc",
            "cmfem_tpu_torch.physics.bprime", "cmfem_tpu_torch.physics.seb",
            "cmfem_tpu_torch.apps.ablation_case2_1",
            "cmfem_tpu_torch.apps.ablation_case2_2",
            "cmfem_tpu_torch.apps.ablation_case2_2_test",
            "cmfem_tpu_torch.motion.recession",
            "cmfem_tpu_torch.motion.remap",
            "cmfem_tpu_torch.core.tracksample",
            "cmfem_tpu_torch.solvers.linemg",
            "cmfem_tpu_torch.kernels.linemg", "cmfem_tpu_torch.parallel",
            "cmfem_tpu_torch.parallel.partition",
            "cmfem_tpu_torch.parallel.sharding",
            "cmfem_tpu_torch.parallel.dofpart",
            "cmfem_tpu_torch.parallel.launch",
            "cmfem_tpu_torch.ops.sumfact_sharded",
            "cmfem_tpu_torch.parallel.ablation_sharded",
            "cmfem_tpu_torch.parallel.ablation_dofpart",
            "cmfem_tpu_torch.io.checkpoint", "cmfem_tpu_torch.io.output",
            "cmfem_tpu_torch.apps.distributed",
            "cmfem_tpu_torch.validation.common",
            "cmfem_tpu_torch.validation.compare_case1",
            "cmfem_tpu_torch.validation.compare_case2",
            "cmfem_tpu_torch.validation.compare_qstar",
            "cmfem_tpu_torch.validation.generate_material",
            "cmfem_tpu_torch.validation.plots",
            "cmfem_tpu_torch.scripts", "cmfem_tpu_torch.scripts.common",
            "cmfem_tpu_torch.scripts.blocksolve_refinement",
            "cmfem_tpu_torch.scripts.fullrun",
            "cmfem_tpu_torch.scripts.oracle_compare",
            "cmfem_tpu_torch.scripts.accuracy_table",
            "cmfem_tpu_torch.scripts.compensated_dots",
            "cmfem_tpu_torch.scripts.comms_model"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cmfem_tpu',\n"
        "                                    'scripts'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run([os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cmfem_tpu_torch" in proc.stderr
