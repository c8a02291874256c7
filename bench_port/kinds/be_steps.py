"""Implicit steps of a structured entry, each solved from a fixed field.

The configuration names the entry of ``cmfem_tpu_torch.entry`` (``entry``
or ``vc_entry``), its order and precision; the workload gives the lattice
(``n`` elements per axis) and the right-hand sides: sums of the sine
``modes`` of ``common.sine_field``, one list of amplitudes per field
(``fields``).  The entry's step solves A x = u, A = mass + dt (convection
+ diffusion) with Dirichlet walls, for the field u it is given (its
right-hand side is the input, not M u_old), so a unit is one independent
solve: no answer feeds the next step, and this is no transient.  The
window solves the fields one after another, closed loop, in an order
drawn from the seed, and again; every seed does the same work.  Set-up
builds the step and solves each field once.  A step counts as failed when
its solve did not converge (GMRES's stagnation exit at the float32 floor
among them).

The check takes a sample of the window's steps, drawn from the seed
(``check_samples``), and holds each step's answer x from its field u to
the configuration's equation with the plain reference: the largest entry
of the Jacobi-scaled residual, max |D^-1 (b(u) - A x)| / max |D^-1 b(u)|,
in float64 (``step_residual``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from bench_port import common
from bench_port.harness import load_module

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class StepResult(NamedTuple):
    """What the window reads of a step's result."""
    x: torch.Tensor
    converged: bool
    inner_iters: int


class Cell:
    def __init__(self, config, workload, seed, device):
        from cmfem_tpu_torch import entry as entries

        self.config, self.workload, self.device = config, workload, device
        self.n = int(workload["n"])
        self.dtype = DTYPES[config["dtype"]]
        make = getattr(entries, config["entry"])
        self.step, (_, self.D) = make(n=self.n, order=int(config["order"]),
                                      device=device, dtype=self.dtype)
        N = self.n * int(config["order"]) + 1
        self.fields = [common.sine_field(N, workload["modes"], a, device,
                                         self.dtype)
                       for a in workload["fields"]]
        self.seed_inputs(seed)

    def seed_inputs(self, seed):
        """The seed's order of the fields, and a fresh sample."""
        g = common.generator(seed, self.device)
        self.order = torch.randperm(len(self.fields), generator=g,
                                    device=self.device).tolist()
        self.sample = common.Reservoir(int(self.workload["check_samples"]),
                                       common.host_rng(seed))

    def warm(self):
        for u in self.fields:
            self.step(u, self.D)

    def window(self, seconds):
        marks = common.Marks(self.device)
        times, steps, failed, inner = [], 0, 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            i = self.order[steps % len(self.order)]
            a = marks.mark()
            res = self.step(self.fields[i], self.D)
            times.append((a, marks.mark()))
            steps += 1
            inner += int(res.inner_iters)
            failed += 0 if res.converged else 1
            self.sample.offer(lambda: (i, res.x.clone()))
        common.sync(self.device)
        window_s = time.perf_counter() - t0
        return {"unit": "step", "attempted": steps, "failed": failed,
                "window_s": window_s,
                "unit_times_s": [marks.seconds(a, b) for a, b in times],
                "inner_iters": inner}

    def span(self):
        """Each field solved once, in the seed's order (the window's mix),
        for the profiler."""
        for i in self.order:
            self.step(self.fields[i], self.D)
        return len(self.order)

    def use_control(self):
        """Put the plain reference in the program's place, computed in the
        configuration's ``control_dtype`` (the precision below its own):
        each step a Jacobi GMRES of the reference operator there."""
        ref = load_module("reference", self.config["reference"]).CdrOperator(
            self.config, self.n, self.device,
            dtype=getattr(torch, self.config["control_dtype"]))
        sv = self.config["solver"]

        def step(u, D):
            x = ref.solve(u, rtol=float(sv["rtol"]),
                          restart=int(sv["restart"]),
                          maxiter=int(sv["maxiter"])).to(self.dtype)
            return StepResult(x, True, 0)

        self.step = step

    def release(self):
        del self.step, self.D

    def check(self):
        ref = load_module("reference", self.config["reference"]).CdrOperator(
            self.config, self.n, self.device)
        worst = max(ref.step_residual(self.fields[i], x)
                    for i, x in self.sample.items)
        return [("step_residual", worst,
                 float(self.workload["limits"]["step_residual"]))]
