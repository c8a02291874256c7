"""apply_roofline_pct.apply: the least time of one apply on the card
(``arithmetic`` and ``peaks``: operations and bytes from the problem's
sizes, whatever implements it) over the device time of all kernels, copies
and fills inside one apply of a profiled span of applies."""


def read(record):
    tr = record.get("trace")
    if (record.get("unit") != "apply" or tr is None or tr.kernel_s <= 0
            or not tr.value):
        return None
    return 100.0 * record["apply_bound_s"] / (tr.kernel_s / tr.value)
