"""The card's peaks and the least time of a piece of work (frozen).

A copy of ``cmfem_tpu_torch/kernels/__init__.py``'s rates and ``bound``,
kept here so that the yardstick does not move with the program: NVIDIA's
data sheet of the H100 SXM (HBM3 3.35 TB/s; 67 TFLOP/s float32 and 34
TFLOP/s float64 outside the tensor cores), at its full 700 W."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

FLOP_RATE = {"float32": F32_FLOP_PER_S, "float64": F64_FLOP_PER_S}


def bound_s(nbytes, flops, dtype="float32"):
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``nbytes`` and do ``flops`` operations in ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOP_RATE[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
