"""krylov_ms_per_iter: the window's wall time over its Arnoldi steps: what
one Krylov iteration costs, host loop and device together."""


def read(record):
    if record.get("unit") != "step" or not record.get("inner_iters"):
        return None
    return 1e3 * record["window_s"] / record["inner_iters"]
