"""Hand-written CUDA kernels of the port: build, binding and wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs the plain
PyTorch version beside it on a CPU tensor; kernels build at first use.

The package also holds what a kernel's device time is read against: the
H100 SXM's memory and arithmetic rates (NVIDIA's data sheet), ``bound``
(the least time the card could take for a given work), ``median_ms``
(ms of a call between CUDA events, the host's enqueue included where the
card waits for it) and ``graph_ms`` (device ms of a call replayed from a
CUDA graph)."""

from __future__ import annotations

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores
F64_FLOP_PER_S = 34e12     # float64 outside the tensor cores


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` operations at ``flop_rate`` (float32
    by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def median_ms(fn, reps=50, warmup=10):
    """Median device ms of one ``fn()`` on the current CUDA device, each
    call between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def graph_ms(fn, calls=10, reps=20):
    """Median device ms per call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed between two events, so the host's enqueue time
    (the wrapper's checks, ctypes) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ts = []
    for _ in range(reps + 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(ts[2:])
