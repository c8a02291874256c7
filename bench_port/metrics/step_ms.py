"""step_ms: the window's wall time over the time steps completed in it
(host clock, all the work and all the time of the window)."""


def read(record):
    if record.get("unit") != "step" or not record.get("attempted"):
        return None
    return 1e3 * record["window_s"] / record["attempted"]
