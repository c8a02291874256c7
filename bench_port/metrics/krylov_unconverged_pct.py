"""krylov_unconverged_pct: the share of the window's steps whose GMRES
ended short of its tolerance (most on its stagnation exit at the float32
floor), each a step counted as failed."""


def read(record):
    if (record.get("unit") != "step" or "inner_iters" not in record
            or not record.get("attempted")):
        return None
    return 100.0 * record["failed"] / record["attempted"]
