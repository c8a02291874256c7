"""host_syncs_per_step: the times a step makes the host wait for the device
(the driver's ``host_syncs`` counter: the timer's own syncs, and each read
of a device value or copy of a host value to the device inside a step),
summed over the window's timing rows and divided by its steps.  None where
the rows carry no such count."""


def read(record):
    rows = record.get("timing_rows")
    if not rows or not all("host_syncs" in r for r in rows):
        return None
    return sum(r["host_syncs"] for r in rows) / len(rows)
