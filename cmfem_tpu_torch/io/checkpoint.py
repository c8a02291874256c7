"""Sharded checkpoint/restore on ``torch.distributed.checkpoint``.

Port of ``cmfem_tpu/io/checkpoint.py`` (orbax there): the multi-rank analog
of the reference's per-rank binary restart files (RestartPathForRank and
its world-size check, ablation_test_case2_1_2D.cpp:982-998, :2733-2738).
Each rank saves and restores only its own slabs: they are stored under
keys of their own (``rank<r>/<name>``), so the checkpoint planner writes
each with the rank that holds it and reads it back on that rank.  A
``meta.json`` beside the state (magic, version, step, time, the world size
as ``n_devices``, the array names) is checked before any array data is
read: a wrong magic, version or world size raises ``ValueError``.

The npz checkpoints of the ablation drivers stay the single-host format;
this is the scale-out path for element- or DOF-partitioned state.  Without
an initialised world the world size is 1.
"""

from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist

_META = "meta.json"
_STATE = "state"
_MAGIC = "cmfem-sharded-ckpt"
_VERSION = 1


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _key(rank, name):
    return f"rank{rank}/{name}"


def save_sharded(path: str, step: int, time: float, arrays: dict) -> None:
    """Save this rank's slabs ({name: tensor}, the same names on every
    rank) plus (step, time); a collective over the world."""
    import torch.distributed.checkpoint as dcp

    rank, size = _world()
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    dcp.save({_key(rank, k): v.contiguous() for k, v in arrays.items()},
             checkpoint_id=os.path.join(path, _STATE), no_dist=size == 1)
    if rank == 0:
        with open(os.path.join(path, _META), "w") as f:
            json.dump({"magic": _MAGIC, "version": _VERSION,
                       "step": int(step), "time": float(time),
                       "n_devices": size, "names": sorted(arrays)}, f)
    if size > 1:
        dist.barrier()


def load_sharded(path: str, device=None):
    """Restore this rank's slabs onto ``device`` (default: where torch puts
    new tensors).  Returns (step, time, {name: tensor}).  Raises ValueError
    on a magic, version or world-size mismatch before any array data is
    read; a collective over the world."""
    import torch.distributed.checkpoint as dcp

    rank, size = _world()
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"Invalid sharded checkpoint magic in: {path}")
    if meta.get("version") != _VERSION:
        raise ValueError(
            f"Unsupported sharded checkpoint version in: {path}")
    if meta["n_devices"] != size:
        raise ValueError(
            f"Sharded checkpoint world size mismatch for {path} "
            f"(file={meta['n_devices']}, run={size}).")
    state_dir = os.path.join(path, _STATE)
    md = dcp.FileSystemReader(state_dir).read_metadata().state_dict_metadata
    state = {}
    for name in meta["names"]:
        tm = md[_key(rank, name)]
        state[_key(rank, name)] = torch.empty(
            tuple(tm.size), dtype=tm.properties.dtype, device=device)
    dcp.load(state, checkpoint_id=state_dir, no_dist=size == 1)
    return (meta["step"], meta["time"],
            {name: state[_key(rank, name)] for name in meta["names"]})
