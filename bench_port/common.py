"""Pieces the generators share: seeded inputs, step clocks, samples."""

from __future__ import annotations

import time

import numpy as np
import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any
    non-negative integer below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def host_rng(seed):
    """The numpy generator that draws a seed's check samples."""
    return np.random.default_rng([int(seed) % (1 << 64), 1])


class Marks:
    """Timestamps taken on the device's stream (CUDA events) or, on the
    CPU, on the host clock; ``seconds(a, b)`` after the window."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, a, b):
        if self.cuda:
            return a.elapsed_time(b) * 1e-3
        return b - a


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    from a seeded generator; ``offer(make)`` calls ``make()`` only for an
    item it keeps."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen = k, rng, 0
        self.items = []

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = make()


def sine_field(n_nodes, modes, amplitudes, device, dtype):
    """sum_m a_m sin(k1 pi x) sin(k2 pi y) sin(k3 pi z) on an equispaced
    lattice of n_nodes per axis of [0, 1]^3 (x fastest): zero on the
    walls.  ``modes`` (M, 3) integers, ``amplitudes`` (M,)."""
    x = torch.linspace(0.0, 1.0, n_nodes, dtype=torch.float64, device=device)
    u = torch.zeros((n_nodes,) * 3, dtype=torch.float64, device=device)
    for (kx, ky, kz), a in zip(modes, amplitudes):
        sx, sy, sz = (torch.sin(k * torch.pi * x) for k in (kx, ky, kz))
        u += float(a) * sz[:, None, None] * sy[None, :, None] * sx[None, None, :]
    return u.reshape(-1).to(dtype)
