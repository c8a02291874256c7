"""mesh_cg_iters_per_step: the iterations of the mesh-velocity smoother's
CG (the driver's ``mesh_cg_iters`` counter), summed over the window's
timing rows and divided by its steps.  None where no row carries the
count."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not any("mesh_cg_iters" in r for r in rows):
        return None
    return sum(r.get("mesh_cg_iters", 0) for r in rows) / len(rows)
