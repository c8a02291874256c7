"""apply_mdofs: DOFs x applies completed over the window's wall time, in
millions per second (the CEED bake-off kernels' figure)."""


def read(record):
    if record.get("unit") != "apply" or not record.get("attempted"):
        return None
    return record["dofs"] * record["attempted"] / record["window_s"] / 1e6
