"""Start a world of ranks on ``torch.distributed``: the port's stand-in for
the JAX package's device mesh of one process (and for ``mpirun -np N``).

``init_rank`` joins the calling process to a world through a ``FileStore``
(no TCP port to collide with other runs): NCCL for ranks on CUDA devices,
gloo for CPU ranks unless a backend is named.  ``spawn_ranks`` runs a
function in ``world_size`` fresh processes (the ``spawn`` start method, one
torch thread each) and returns their results in rank order; a rank that
raises, dies or outlives ``timeout`` fails the call in seconds, never a
hang; a rank's stderr goes to a file, whose last lines the error carries
when the rank dies without a result.  The function runs with the world
initialised and torn down around it; it builds its own
``parallel.make_device_mesh``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def init_rank(rank: int, world_size: int, store_path: str, *, device,
              backend: str | None = None, timeout: float = 60.0):
    """Join rank ``rank`` of ``world_size`` through the file ``store_path``
    (the same new path for every rank).  ``backend`` defaults to NCCL on a
    CUDA device and gloo on the CPU; NCCL that this torch lacks raises."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("init_rank: NCCL is not available in this torch "
                           "build; CUDA ranks need it")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(store_path)}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def _rank_main(fn, rank, world_size, store_path, device, backend, timeout,
               args, results, err_path):
    # this process's stderr into a file, so that the parent can report what
    # a rank that dies (a C++ abort, a signal) printed last
    err = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(err, 2)
    os.close(err)
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda" and torch.device(device).index \
            is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    try:
        init_rank(rank, world_size, store_path, device=device,
                  backend=backend, timeout=timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def spawn_ranks(fn, world_size: int, args=(), *, device="cpu",
                backend: str | None = None, timeout: float = 120.0):
    """[fn(*args) of rank 0, ..., of rank world_size - 1], each run in a
    process of its own.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``device``: "cpu", or "cuda" for rank r on
    card r % device_count.  Raises RuntimeError with a rank's traceback,
    or TimeoutError when the ranks have not all answered in ``timeout``
    seconds (each process is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="cmfem_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        err_path = lambda r: os.path.join(tmp, f"rank{r}.err")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, store, str(device), backend, timeout,
                  args, results, err_path(r)), daemon=True)
            for r in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, err, out = results.get(timeout=0.5)
                    got[rank] = (err, out)
                    if err:  # the others may wait on it in a collective
                        break
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    # let a message sent just before the exit arrive
                    time.sleep(0.5)
                    while not results.empty():
                        rank, err, out = results.get()
                        got[rank] = (err, out)
                    dead = [r for r in dead if r not in got]
                    if dead:
                        with open(err_path(dead[0])) as f:
                            tail = f.read()[-2000:]
                        raise RuntimeError(
                            f"spawn_ranks: rank {dead[0]} exited "
                            f"({procs[dead[0]].exitcode}) without a result; "
                            f"its stderr ends:\n{tail}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn_ranks: {world_size - len(got)} of "
                        f"{world_size} ranks gave no result in {timeout} s")
        finally:
            failed = any(e for e, _ in got.values()) or len(got) < world_size
            for p in procs:
                p.join(timeout=0.1 if failed else 5.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
    errors = [(r, e) for r, (e, _) in sorted(got.items()) if e]
    if errors:
        r, e = errors[0]
        raise RuntimeError(f"spawn_ranks: rank {r} of {world_size} "
                           f"failed:\n{e}")
    return [got[r][1] for r in range(world_size)]
