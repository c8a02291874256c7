"""jacobian_ms_per_step: the driver's ``timing`` rows' ``jacobian``
(its StepTimer phase, device-synchronised host clock: the AD element
Jacobians), per step of the window."""


def read(record):
    rows = record.get("timing_rows")
    if not rows:
        return None
    return 1e3 * sum(r.get("jacobian", 0.0) for r in rows) / len(rows)
