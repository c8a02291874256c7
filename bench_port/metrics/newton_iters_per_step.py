"""newton_iters_per_step: the driver's Newton linear solves per step
(``newton_iters`` of its result), over the window's steps."""


def read(record):
    it = record.get("newton_iters")
    if not it:
        return None
    return sum(it) / len(it)
