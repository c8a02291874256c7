"""cmfem_tpu_torch — the PyTorch/CUDA port of ``cmfem_tpu``.

The JAX package ``cmfem_tpu`` stays the reference; this package mirrors its
layout and names and never imports jax:

  core/      mesh, reference elements, quadrature, H1 space, point location
             (numpy copies), geometric and face factors
  ops/       assembly into quadrature-point data, linear forms, error norms,
             essential BCs, the element-batched and the sum-factorized
             structured operators
  kernels/   hand-written CUDA kernels: build, ctypes binding, wrappers
  csrc/      the kernels' CUDA C++ sources (built for sm_90a at first use)
  solvers/   CG, GMRES, Jacobi and Chebyshev preconditioners, structured and
             geometric multigrid, dense LU, DIRK time stepping, Newton
  io/ utils/ CSV and VTU output, YAML configuration, step timing
  native     ctypes loader of native/libcmfem_native.so (gmsh parser,
             bucket-grid point locator)
  apps/      the application drivers: run(cfg, device=None) and main(argv)
  interop    numpy arrays from the JAX package -> the port's objects
  entry      the structured main paths: implicit BE steps of 3D CDR, the
             MG solve, the operator-apply sweep
"""

import torch

# True-f32 products everywhere, as ``cmfem_tpu/__init__.py`` requests
# Precision.HIGHEST: reduced-precision operands (bf16 on the TPU, TF32
# here) corrupted the assembled D by 26% at 48^3.  A float32 matmul runs
# in TF32 only when allowed; cuDNN allows it by default.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when there is none.

    The port's main path runs on the GPU; it never picks the CPU quietly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cmfem_tpu_torch: no CUDA device is available; the main path "
            "runs on the GPU only (pass device='cpu' explicitly for the "
            "plain PyTorch versions)")
    return torch.device("cuda", torch.cuda.current_device())
