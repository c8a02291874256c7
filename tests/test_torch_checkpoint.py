"""``io/checkpoint.py`` (port of ``cmfem_tpu/io/checkpoint.py``, orbax there,
``torch.distributed.checkpoint`` here): on a gloo world of 2 CPU ranks each
rank saves the slabs of a ``DofPartitionedAblationNewton`` state and loads
them back equal bit for bit; ``meta.json`` holds the magic, version, step,
time, world size and names; a load refuses a wrong world size, magic or
version with a ``ValueError`` in the JAX package's words, before it reads
any array data (the refusals hold with the array data removed)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from cmfem_tpu_torch.io.checkpoint import load_sharded, save_sharded
from cmfem_tpu_torch.parallel import spawn_ranks

DECK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "tacot_synthetic.json")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "state")
    ranks = spawn_ranks(H.checkpoint_round_trip, 2, (2, path, DECK),
                        timeout=120)
    return path, ranks


def test_round_trip_bit_for_bit_per_rank(saved):
    _, ranks = saved
    for r in ranks:
        assert (r["step"], r["time"]) == (7, 0.7)
        assert sorted(r["loaded"]) == sorted(r["saved"])
        for k, a in r["saved"].items():
            b = r["loaded"][k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), (r["rank"], k)
        assert set(r["devices"].values()) == {"cpu"}
    # each rank holds its own slab of the two-field vector
    assert not np.array_equal(ranks[0]["saved"]["y"], ranks[1]["saved"]["y"])


def test_meta_records_the_world(saved):
    path, _ = saved
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"magic": "cmfem-sharded-ckpt", "version": 1, "step": 7,
                    "time": 0.7, "n_devices": 2,
                    "names": ["To", "Xo", "po", "y"]}


def _copy_without_arrays(path, tmp_path, **meta_edit):
    """The checkpoint's meta.json alone (edited), its array data gone."""
    dst = tmp_path / "ckpt"
    dst.mkdir()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta.update(meta_edit)
    with open(dst / "meta.json", "w") as f:
        json.dump(meta, f)
    return str(dst)


@pytest.mark.parametrize("edit,words", [
    ({}, "world size"), ({"magic": "orbax"}, "magic"),
    ({"version": 2}, "version")])
def test_load_refusals_before_any_array_data(saved, tmp_path, edit, words):
    path = _copy_without_arrays(saved[0], tmp_path, **edit)
    with pytest.raises(ValueError, match=words):
        load_sharded(path)


def test_single_process_round_trip(tmp_path):
    arrays = {"a": torch.arange(12, dtype=torch.float64).reshape(3, 4),
              "b": torch.tensor([1, 2, 3])}
    save_sharded(str(tmp_path / "one"), 3, 1.5, arrays)
    step, t, got = load_sharded(str(tmp_path / "one"))
    assert (step, t) == (3, 1.5)
    for k, v in arrays.items():
        assert torch.equal(got[k], v) and got[k].dtype == v.dtype
    shutil.rmtree(tmp_path / "one" / "state")
    with pytest.raises(FileNotFoundError):
        load_sharded(str(tmp_path / "one"))


@pytest.mark.gpu
def test_cuda_round_trip_on_two_gloo_ranks(tmp_path):
    """On the card: two gloo ranks save and load CUDA slabs, bit for bit,
    back onto the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = spawn_ranks(H.checkpoint_round_trip, 2,
                        (2, str(tmp_path / "c"), DECK, "cuda"),
                        device="cuda", backend="gloo", timeout=180)
    for r in ranks:
        assert all(np.array_equal(a, r["loaded"][k])
                   for k, a in r["saved"].items())
        assert all(d.startswith("cuda") for d in r["devices"].values())
    with pytest.raises(ValueError, match="world size"):
        load_sharded(str(tmp_path / "c"))
