"""Back-to-back applies of a structured entry's bound operator.

As the CEED bake-off kernels (BK) are run: the operator that the
configuration's entry binds (``step.fn``, the ``best_bind`` path) is
applied to ``vectors`` vectors drawn from the seed (standard normal, in
the configuration's precision), in turn, with no solver around it and no
synchronisation between applies; the window ends with one.

The check covers the first output of each vector in the window and a
sample of the window's applies drawn from the seed (``check_samples``).
The plain reference's float64 apply judges each first output y_1; a
sampled apply keeps, on the device and with no sync, only
d = max |y - y_1| against the first output of its vector, so that hundreds
of samples hold no copies of the output.  Its error is bounded by
(d + max |y_1 - y_ref|) / max |y_ref| (the triangle inequality), and the
largest such bound is compared (``apply_error``); on a sound program the
applies of one input agree and d is 0.
"""

from __future__ import annotations

import time

import torch

from bench_port import arithmetic, common, peaks
from bench_port.harness import load_module

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Cell:
    def __init__(self, config, workload, seed, device):
        from cmfem_tpu_torch import entry as entries

        self.config, self.workload, self.device = config, workload, device
        self.n = int(workload["n"])
        dtype = DTYPES[config["dtype"]]
        make = getattr(entries, config["entry"])
        step, (_, self.D) = make(n=self.n, order=int(config["order"]),
                                 device=device, dtype=dtype)
        self.fn = step.fn
        self.ndofs = (self.n * int(config["order"]) + 1) ** 3
        self.dtype = dtype
        self.chunk = int(workload["chunk"])
        self.seed_inputs(seed)

    def seed_inputs(self, seed):
        """The seed's vectors and sample (a fresh sample)."""
        g = common.generator(seed, self.device)
        self.vs = torch.randn((int(self.workload["vectors"]), self.ndofs),
                              generator=g, device=self.device,
                              dtype=self.dtype)
        self.sample = common.Reservoir(int(self.workload["check_samples"]),
                                       common.host_rng(seed))
        self.first = [None] * len(self.vs)

    def warm(self):
        for v in self.vs:
            self.fn(v, self.D)

    def window(self, seconds):
        nv, applies = len(self.vs), 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            for _ in range(self.chunk):
                i = applies % nv
                y = self.fn(self.vs[i], self.D)
                if applies < nv:
                    self.first[i] = y.clone()
                self.sample.offer(
                    lambda: (i, (y - self.first[i]).abs().max()))
                applies += 1
        common.sync(self.device)
        window_s = time.perf_counter() - t0
        flops, nbytes = self.apply_work()
        return {"unit": "apply", "attempted": applies, "failed": 0,
                "window_s": window_s, "dofs": self.ndofs,
                "dtype": self.config["dtype"], "apply_flops": flops,
                "apply_bound_s": peaks.bound_s(nbytes, flops,
                                               self.config["dtype"])[0]}

    def apply_work(self):
        """(FLOPs, bytes) of one apply from the problem's sizes."""
        p = int(self.config["order"])
        q1 = int(self.config["points_per_axis"])
        planes = int(self.config["d_planes"])
        item = torch.empty((), dtype=self.dtype).element_size()
        return (arithmetic.sumfact_apply_flops(self.n, p, q1, planes),
                arithmetic.sumfact_apply_bytes(self.n, p, q1, planes, item))

    def span(self, key="span_applies"):
        """``span_applies`` applies in a row for the profiler."""
        k = int(self.workload[key])
        for j in range(k):
            self.fn(self.vs[j % len(self.vs)], self.D)
        return k

    def gap_span(self):
        """``gap_span_applies`` applies in a row, traced with the host."""
        return self.span("gap_span_applies")

    def use_control(self):
        """Put the plain reference's apply in the program's place, computed
        in the configuration's ``control_dtype``."""
        ref = load_module("reference", self.config["reference"]).CdrOperator(
            self.config, self.n, self.device,
            dtype=getattr(torch, self.config["control_dtype"]))
        self.fn = lambda v, D: ref.apply(v).to(self.dtype)

    def release(self):
        del self.fn, self.D

    def check(self):
        ref = load_module("reference", self.config["reference"]).CdrOperator(
            self.config, self.n, self.device)
        first = {}
        for i, y in enumerate(self.first):
            if y is not None:
                y_ref = ref.apply(self.vs[i])
                first[i] = (float((y.double() - y_ref).abs().max()),
                            float(y_ref.abs().max()))
        worst = max((first[i][0] + float(d)) / first[i][1]
                    for i, d in [(i, 0.0) for i in first]
                    + self.sample.items)
        return [("apply_error", worst,
                 float(self.workload["limits"]["apply_error"]))]
