"""step_rest_ms_per_step: the part of each step outside the Jacobian and
the linear solve: each timing row's ``step_wall`` (the driver's span around
the whole step) less its ``jacobian``, ``factorization`` and ``linear``
phases, summed over the window's rows and divided by its steps (residual,
bc, update, state advance, outputs and what no phase covers).  None where
the rows carry no ``step_wall``."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not all("step_wall" in r for r in rows):
        return None
    return 1e3 * sum(r["step_wall"] - r.get("jacobian", 0.0)
                     - r.get("factorization", 0.0) - r.get("linear", 0.0)
                     for r in rows) / len(rows)
