"""The JAX package's line-multigrid GMRES counts on chip_smoke phase 14a's
two systems (the first Newton system of case 1's step 1 on the 11 x 239
strip and on that strip refined twice), which chip_smoke holds the card
to (``JAX_14A_LINEMG``).  The port builds each system on the CPU; both
packages' ``BlockNewtonKrylov(pc="linemg")`` (restart 400, rtol 1e-12)
solve it from the same numpy arrays.

    python tests/jax_linemg_counts.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cmfem_tpu.solvers import BlockNewtonKrylov as JBNK  # noqa: E402
from cmfem_tpu_torch.apps.ablation_case1 import TIMING_KEYS  # noqa: E402
from cmfem_tpu_torch.profiling import first_newton_system  # noqa: E402
from cmfem_tpu_torch.solvers.blocksolve import (  # noqa: E402
    BlockNewtonKrylov, strip_dof_lattice)


def main():
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for lv in (0, 2):
            c, blocks, R = first_newton_system("cpu", tmp, lv, f"j{lv}")
            ed = c.fes.element_dofs
            lat = strip_dof_lattice(c.fes.node_positions)
            b = -R.numpy()
            jb = JBNK(ed, c.n, c.ess, c.ess, restart=400, maxiter=10,
                      dof_lattice=lat, pc="linemg")
            rj = jb.solve(jb.prepare(tuple(jnp.asarray(x.numpy())
                                           for x in blocks)),
                          jnp.asarray(b), rtol=1e-12)
            tb = BlockNewtonKrylov(ed, c.n, c.ess, c.ess, restart=400,
                                   maxiter=10, dof_lattice=lat, pc="linemg",
                                   device="cpu")
            rt = tb.solve(tb.prepare(blocks), -R, rtol=1e-12)
            A = c.host_matrix(blocks)
            tr = lambda x: float(np.linalg.norm(A @ np.asarray(x) - b)
                                 / np.linalg.norm(b))
            counts[2 * c.n] = int(rj.inner_iters)
            print(f"{2 * c.n} DOFs: JAX {int(rj.inner_iters)} inner "
                  f"iterations (true rel residual {tr(rj.x):.3e}); port on "
                  f"the CPU {rt.inner_iters} ({tr(rt.x.numpy()):.3e})")
            c.finish({k: 0.0 for k in TIMING_KEYS + ("newton", "total")},
                     0.0)
    print("JAX_14A_LINEMG =", counts)


if __name__ == "__main__":
    main()
