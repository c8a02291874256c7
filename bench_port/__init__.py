"""bench_port: the benchmark of ``cmfem_tpu_torch`` on an NVIDIA H100.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Nothing here imports JAX or the JAX package; see README.md."""
