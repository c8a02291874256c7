"""What the study modules share: the device and output directory of a run,
the repo's synthetic inputs, and the meshes the studies write themselves.

The JAX package's scripts read the reference decks and meshes under an
external reference directory; the port's read what the repo holds
(``tests/fixtures/``) and write their meshes with ``core.write_gmsh``."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from ..apps.common import device_from_env, resolve_device
from ..core import make_cartesian_mesh_2d, make_strip_mesh_2d, write_gmsh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# the synthetic TACOT deck (stands in for material_tacot_case*.yaml)
TACOT_DECK = os.path.join(FIXTURES, "tacot_synthetic.json")
# the synthetic surface schedule of case 2.1 (stands in for the reference's
# surface BC file); it ends at t = 2.0 s
SCHEDULE = os.path.join(FIXTURES, "surface_bc_case21.dat")
# make_strip_mesh_2d's top boundary attribute: the reference's
# ablation_strip.msh names its top 1, the port's strip 3 (bottom 1)
STRIP_TOP = 3
STRIP_BOTTOM = 1


def add_run_args(ap):
    """--cpu and --out-dir, which every study takes."""
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (also CMFEM_FORCE_CPU=1); the "
                         "default is the CUDA device, and none is an error")
    ap.add_argument("--out-dir", default=None,
                    help="where the run writes (default: a new directory "
                         "under the system's temporary directory)")
    return ap


def run_device(cpu=False) -> torch.device:
    """The CPU when asked for (``cpu`` or CMFEM_FORCE_CPU=1), else the CUDA
    device (RuntimeError without one), as the drivers' ``main``."""
    return resolve_device("cpu" if cpu else device_from_env())


def cpu_only(cpu, why) -> torch.device:
    """The CPU for a run that is the CPU's by design (``why`` says which),
    when the caller asks for it (``cpu`` or CMFEM_FORCE_CPU=1); otherwise a
    RuntimeError naming the reason, since an entry point of the port runs
    on the card unless told otherwise."""
    if cpu or device_from_env() == "cpu":
        return torch.device("cpu")
    raise RuntimeError(f"{why}: ask for the CPU with --cpu or "
                       f"CMFEM_FORCE_CPU=1")


def out_dir(path, name):
    """``path`` (created), or a new directory for study ``name`` under the
    system's temporary directory."""
    if path is None:
        return tempfile.mkdtemp(prefix=f"cmfem_{name}_")
    os.makedirs(path, exist_ok=True)
    return path


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def card(device):
    """The device a figure was taken on: for a card its name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them, for the CPU "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    idx = device.index or 0
    return smi[idx] if idx < len(smi) else torch.cuda.get_device_name(idx)


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device):
    """Peak device memory since ``reset_peak``, GiB (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- meshes ------------------------------------------------------------------

def disc_mesh(n):
    """The unit disc as n x n x 2 triangles: the square [-1, 1]^2 under
    (x, y) -> (x sqrt(1 - y^2/2), y sqrt(1 - x^2/2)), which takes the
    square's boundary onto the unit circle."""
    mesh = make_cartesian_mesh_2d(n, n, sx=2.0, sy=2.0, x0=-1.0, y0=-1.0,
                                  geom="triangle")
    x, y = mesh.vertices[:, 0], mesh.vertices[:, 1]
    return mesh.with_vertices(np.stack(
        [x * np.sqrt(1.0 - 0.5 * y * y), y * np.sqrt(1.0 - 0.5 * x * x)],
        axis=1))


def strip_file(directory, nx=11, ny=239, geom="quad"):
    """The graded TACOT strip (11 x 239 cells: the reference's
    ablation_strip.msh at refine 0) as a GMSH file in ``directory``."""
    return write_gmsh(make_strip_mesh_2d(nx, ny, geom=geom),
                      os.path.join(directory, f"strip_{geom}_{nx}x{ny}.msh"))


def square_file(directory, n, scale=1.0):
    """[0, scale]^2 as n x n x 2 triangles (unit_square.msh at scale 1,
    square_0p01.msh at 0.01)."""
    mesh = make_cartesian_mesh_2d(n, n, sx=scale, sy=scale, geom="triangle")
    return write_gmsh(mesh, os.path.join(directory,
                                         f"square_{n}_{scale:g}.msh"))


def disc_file(directory, n):
    """The unit disc of ``disc_mesh(n)`` (unit_circle.msh)."""
    return write_gmsh(disc_mesh(n), os.path.join(directory,
                                                 f"disc_{n}.msh"))
