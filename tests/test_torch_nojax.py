"""The port stands alone: no module of cmfem_tpu_torch (nor chip_smoke.py)
imports jax or the JAX package, and chip_smoke.py refuses to run without a
GPU or without the package beside it."""

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
            "cmfem_tpu_torch.solvers.krylov"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cmfem_tpu'))\n"
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
