"""mesh_motion_ms_per_step: the driver's ``timing`` rows' ``recession``
(its StepTimer phases of the moving mesh before the solve: the recession
velocity, the mesh velocity, the extent remap and the move), per step of
the window.  None where no row carries the phase."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not any("recession" in r for r in rows):
        return None
    return 1e3 * sum(r.get("recession", 0.0) for r in rows) / len(rows)
