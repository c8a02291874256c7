"""face_jacobian_ms_per_step: the driver's ``timing`` rows'
``face_jacobian`` (its StepTimer phase around the SEB face Jacobians,
device-synchronised host clock, inside the ``jacobian`` phase), per step
of the window.  None where no row carries the phase."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not any("face_jacobian" in r for r in rows):
        return None
    return 1e3 * sum(r.get("face_jacobian", 0.0) for r in rows) / len(rows)
