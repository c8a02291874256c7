"""device_idle_pct.apply: the share of the window in which no kernel, copy
or fill ran on the device: one less the device's busy time per unit of a
span of applies profiled with CUDA activity alone (torch.profiler's trace)
over the window's wall time per unit.  The span's own wall is not the
divisor: the profiler slows the host's launches, so that the span runs
longer a unit than the window does."""


def read(record):
    tr = record.get("trace")
    if (record.get("unit") != "apply" or tr is None or tr.busy_s <= 0
            or not tr.value or not record.get("attempted")):
        return None
    busy = tr.busy_s / tr.value
    wall = record["window_s"] / record["attempted"]
    return 100.0 * (1.0 - busy / wall)
