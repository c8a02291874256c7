"""krylov_iters_per_step: Arnoldi steps (``SolveResult.inner_iters``,
summed over restarts) per time step in the window."""


def read(record):
    if record.get("unit") != "step" or "inner_iters" not in record:
        return None
    return record["inner_iters"] / record["attempted"]
