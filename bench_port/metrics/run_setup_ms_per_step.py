"""run_setup_ms_per_step: each driver run's set-up (``run_setup``: mesh,
space, assembly, system, solver, initial fields and step-0 outputs) and
finish (``run_finish``: the summary CSVs and the returned copies), the
spans of the driver's StepTimer in its first and last timing rows, summed
over the window's rows and divided by its steps.  None where the rows carry
no such span."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not any("run_setup" in r for r in rows):
        return None
    return 1e3 * sum(r.get("run_setup", 0.0) + r.get("run_finish", 0.0)
                     for r in rows) / len(rows)
