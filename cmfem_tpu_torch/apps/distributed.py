"""The ablation drivers' ``sharding_devices: N`` and ``dof_partition: N``.

In the JAX package one process drives an N-device mesh; here a rank is a
process, so a driver runs the same host loop on every rank of a world of N
(SPMD, as the reference's drivers run under ``mpirun -np N``): the
residual, the AD Jacobian and the block GMRES of each Newton iterate run
distributed (``parallel.ShardedAblationNewton`` or
``parallel.DofPartitionedAblationNewton``), every other piece of the step
runs whole on every rank, and only rank 0 writes CSV, VTU and restart
files (``io.file_output``).  Every rank returns the same dict.

``spmd_run`` starts the world when there is none: on the CPU N gloo
ranks (``parallel.spawn_ranks``), on CUDA one NCCL rank per card (it
raises when there are fewer cards than N); N = 1 runs in this process.
A run inside an initialised world runs as its rank, and
``make_device_mesh`` refuses a world of another size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import sys
import tempfile

import torch

WORLD_TIMEOUT = 86400.0


def distributed_option(cfg: dict):
    """(option, N) of a config: ("sharding_devices", N),
    ("dof_partition", N) or (None, 0).  Both set is a ValueError, in the
    JAX drivers' words."""
    shard_n = int(cfg.get("sharding_devices", 0))
    dofp_n = int(cfg.get("dof_partition", 0))
    if shard_n and dofp_n:
        raise ValueError(
            "sharding_devices and dof_partition are mutually exclusive")
    if shard_n:
        return "sharding_devices", shard_n
    if dofp_n:
        return "dof_partition", dofp_n
    return None, 0


def in_world() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_rank() -> int:
    """This process's rank in the initialised world."""
    import torch.distributed as dist

    return dist.get_rank()


def host_result(out: dict) -> dict:
    """A driver's result with every tensor as a numpy array (a spawned rank
    sends it to the parent; a tensor would travel as shared memory that
    dies with the rank); the mesh-motion handler, which holds device
    state, becomes None."""
    def host(v):
        if torch.is_tensor(v):
            return v.detach().cpu().numpy()
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: host(getattr(v, f.name))
                for f in dataclasses.fields(v)
                if torch.is_tensor(getattr(v, f.name))})
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    return {k: None if k == "handler" else host(v) for k, v in out.items()}


def _driver_rank(module, cfg, kind, dtype):
    """One rank of a spawned driver run: ``module.run`` on this rank's
    device (``cuda:rank`` on the card), printing on rank 0 only."""
    import torch.distributed as dist

    rank = dist.get_rank()
    device = torch.device("cpu") if kind == "cpu" else \
        torch.device("cuda", rank % torch.cuda.device_count())
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(
            sys.stdout if rank == 0 else null):
        out = importlib.import_module(module).run(cfg, device=device,
                                                  dtype=dtype)
    return host_result(out)


def spmd_run(module: str, cfg: dict, option: str, n: int, device,
             dtype):
    """Rank 0's result of ``module.run(cfg)`` on a world of ``n`` ranks
    (``option``: n) started here, or None when this process already is a
    rank of a world (the caller then runs its loop as that rank).  A rank
    that raises fails the run at once; a world that outlives
    ``WORLD_TIMEOUT`` seconds is taken as hung."""
    from ..parallel import init_rank, spawn_ranks

    if in_world():
        return None
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"{option}: {n} needs {n} cards (one NCCL rank per card) but "
            f"{torch.cuda.device_count()} exist")
    timeout = WORLD_TIMEOUT
    if n == 1:
        with tempfile.TemporaryDirectory(prefix="cmfem_ranks_") as tmp:
            init_rank(0, 1, os.path.join(tmp, "store"), device=device,
                      timeout=timeout)
            try:
                return importlib.import_module(module).run(
                    cfg, device=device, dtype=dtype)
            finally:
                import torch.distributed as dist

                dist.destroy_process_group()
    return spawn_ranks(_driver_rank, n, (module, cfg, device.type, dtype),
                       device=device.type, timeout=timeout)[0]


def run_on_ranks(module: str, run_local, cfg: dict, device, dtype):
    """A driver's eager run: ``run_local(cfg, device, dtype)`` in this
    process, or, with ``sharding_devices: N`` / ``dof_partition: N``,
    ``run_local(cfg, device, dtype, option, N)`` on every rank of a world
    of N (started by ``spmd_run`` when there is none), rank 0 writing the
    files."""
    from ..io import file_output

    option, n = distributed_option(cfg)
    if not n:
        return run_local(cfg, device, dtype)
    out = spmd_run(module, cfg, option, n, device, dtype)
    if out is not None:
        return out
    with file_output(world_rank() == 0):
        return run_local(cfg, device, dtype, option, n)


class DistributedNewton:
    """The distributed Newton pieces of a driver's rank: one
    ``ShardedAblationNewton`` or ``DofPartitionedAblationNewton`` per key
    (the flux branch of cases 2.1/2.2: the branch changes the face
    residual), the step's old-state slabs, and the residual and
    ``factorize`` of ``run_tp_newton_loop`` on global (T, p) tensors.
    ``results`` collects every GMRES ``SolveResult``."""

    def __init__(self, option, n, sys_, ess_T, ess_p, cfg, device,
                 ale_toggles=(True, True, True), gcl_enabled=False):
        from ..parallel import (DofPartitionedAblationNewton,
                                ShardedAblationNewton, make_device_mesh)

        self.option = option
        self.dofpart = option == "dof_partition"
        self.cls = DofPartitionedAblationNewton if self.dofpart \
            else ShardedAblationNewton
        self.mesh = make_device_mesh(n, device=device)
        self.sys = sys_
        self.ess_T, self.ess_p = ess_T, ess_p
        self.kw = dict(restart=int(cfg.get("gmres_restart", 400)),
                       maxiter=int(cfg.get("gmres_maxiter", 10)),
                       ale_toggles=ale_toggles)
        if self.dofpart:
            self.kw["gcl_enabled"] = gcl_enabled
        self.lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
        self.cache = {}
        self.results = []
        self.slabs = {}

    def get(self, key="default", seb=None):
        """The Newton instance of ``key``, built at its first use."""
        if key not in self.cache:
            self.cache[key] = inst = self.cls(self.sys, self.mesh,
                                              self.ess_T, self.ess_p,
                                              seb=seb, **self.kw)
            print(self.describe(inst))
        return self.cache[key]

    def describe(self, inst):
        n = self.sys.n
        if self.dofpart:
            return (f"dof partitioning over {self.mesh.size} ranks "
                    f"(per-rank two-field floats {inst.per_device_floats()} "
                    f"vs replicated {2 * n})")
        return (f"element sharding over {self.mesh.size} ranks "
                f"({inst.ne_pad} padded elements)")

    def set_step(self, inst, T_old_q, p_old_q, X_old, wq=None, gcl=None):
        """This rank's slabs of the step's old state (and ALE terms)."""
        if self.dofpart:
            pack = lambda a, fill="dup": inst.pack_elem(a, fill)
        else:
            pack = lambda a, fill=None: inst.pad_elem(a)
        self.slabs = {
            "To": pack(T_old_q), "po": pack(p_old_q), "Xo": pack(X_old),
            "wq": None if wq is None else pack(wq, "zero"),
            "gcl": None if gcl is None else (pack(gcl[0]), pack(gcl[1]))}

    def _args(self):
        s = self.slabs
        return (s["To"], s["po"], s["Xo"])

    def residual(self, inst, T, p, dt, bc=None):
        """The BC-masked global residual (2n,), the same on every rank."""
        s = self.slabs
        if not self.dofpart:
            return inst.residual(T, p, *self._args(), dt, bc=bc, wq=s["wq"],
                                 gcl=s["gcl"])
        R = inst.residual(inst.to_dist2(T, p), *self._args(), dt, bc=bc,
                          wq=s["wq"], gcl=s["gcl"])
        return torch.cat(inst.gather2(R))

    def factorize(self, inst, T, p, dt, bc=None):
        """``prepare`` at (T, p); ``.solve(rhs)`` of the result gives the
        global dx on every rank."""
        from .common import check_linear_result

        s = self.slabs
        n = self.sys.n
        args = (inst.to_dist2(T, p), *self._args(), dt) if self.dofpart \
            else (T, p, *self._args(), dt)
        fac = inst.prepare(*args, bc=bc, wq=s["wq"], gcl=s["gcl"])
        owner = self

        class _Prepared:
            def solve(self, rhs):
                b = inst.to_dist2(rhs[:n], rhs[n:]) if owner.dofpart \
                    else rhs
                res = inst.solve(fac, b, rtol=owner.lin_rtol)
                owner.results.append(res)
                check_linear_result(res, f"distributed block GMRES "
                                    f"({owner.option})")
                return torch.cat(inst.gather2(res.x)) if owner.dofpart \
                    else res.x

        return _Prepared()
