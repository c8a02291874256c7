"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``cmfem_tpu_torch``.  The last line
of standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit, which also end standard
error).  Without the CUDA devices the cell asks for it exits 2 and prints
no result; if JAX or the JAX package was loaded, 3."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the libraries' pools, and the process on the last
# two cores it may use, the same in every run: the cells are host-bound
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
_cores = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, _cores[-2:])

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    from bench_port import harness

    harness.setup_environment(ROOT)
    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
