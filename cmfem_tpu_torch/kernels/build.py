"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each library is compiled for Hopper (``sm_90a``) from the sources under
``cmfem_tpu_torch/csrc/`` at first use, into ``cmfem_tpu_torch/_build/``,
keyed by a hash of the sources and flags, and loaded with ``ctypes``.  The
sources export a plain C interface, so no PyTorch header is compiled and a
build takes seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (CDLL, build seconds, nvcc's output)
_LIBS: dict[str, tuple[ctypes.CDLL, float, str]] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, PATH, or the toolkit's default prefix."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``csrc/<sources>``.

    Raises RuntimeError with nvcc's output when the build fails."""
    if name in _LIBS:
        return _LIBS[name][0]
    paths = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    so_log = so.with_suffix(".log")  # nvcc's output, kept for cached loads
    t0 = time.perf_counter()
    if so.exists():
        log = so_log.read_text() if so_log.exists() else ""
    else:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(exit {proc.returncode}):\n{log}")
        # atomic renames: concurrent builds race harmlessly
        with tempfile.NamedTemporaryFile("w", dir=BUILD_DIR, suffix=".log",
                                         delete=False) as f:
            f.write(log)
        os.replace(f.name, so_log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = (lib, time.perf_counter() - t0, log)
    return lib


def build_info(name: str) -> tuple[float, str]:
    """(seconds the first ``load_library`` call took, nvcc's output from
    the build of the loaded library, also when it was loaded from the
    build directory)."""
    _, secs, log = _LIBS[name]
    return secs, log


def ptxas_resources(nvcc_log: str, entry: str) -> dict[str, tuple[int, int]]:
    """{mangled entry name: (registers, spill bytes stored + loaded)} of the
    kernels whose mangled name contains ``entry``, from ``ptxas -v``: an
    entry's "Compiling entry" line, then its spill line, then its registers
    line."""
    out, name, spill = {}, None, 0
    for line in nvcc_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"'(\w+)'", line)
            name = m[1] if m and entry in m[1] else None
        elif name and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif name and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line)[1]),
                         spill)
            name = None
    return out
