"""step_p95_ms: the 95th percentile (nearest rank) of every step's time in
the window, each taken between two CUDA events on the stream around the
step (device timestamps; the device waits idle between steps, so each
interval is the step's wall time)."""

import math


def read(record):
    t = record.get("unit_times_s")
    if record.get("unit") != "step" or not t:
        return None
    s = sorted(t)
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
