"""linear_ms_per_step: the driver's ``timing`` rows' ``factorization`` and
``linear`` (the block linear solve: host splu, or the device block
solvers), per step of the window."""


def read(record):
    rows = record.get("timing_rows")
    if not rows:
        return None
    return 1e3 * sum(r.get("factorization", 0.0) + r.get("linear", 0.0)
                     for r in rows) / len(rows)
