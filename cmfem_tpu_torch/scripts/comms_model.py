"""Communication volume of the distributed paths, counted where it is sent.

Port of the JAX package's ``scripts/comms_model.py``.  The JAX study
compiles its SPMD programs and parses the collectives out of the HLO; the
port has no HLO, so ``CollectiveLog`` (a context manager) wraps
``torch.distributed.all_reduce``, ``all_gather``,
``all_gather_into_tensor``, ``isend`` and ``irecv`` (which
``batch_isend_irecv`` calls for each of its ops) while a known number of
applies or CG iterations runs, and records each call's op, dtype, shape
and bytes (all_reduce: the tensor; all_gather: the gathered output;
isend/irecv: the tensor sent or received).  The library itself is not
changed.  Per-apply and per-iteration figures are the difference between
two runs of different lengths, so set-up and epilogue traffic is
classified apart.

Paths, as the JAX study models them:

  z-sharded sum-factorized apply (``ops.sumfact_sharded``): 8 x 8 x 4N
      hexes, order 2, float32; per apply
  DOF-partitioned CG (``parallel.dofpart.DofPartitionedOperator`` under
      ``solvers.krylov.cg``): the unit square as 22 x 22 x 2 triangles
      (in place of the reference's unit_square.msh), order 2, float32; per
      CG iteration

Each world size N runs in one spawn of N gloo ranks on the CPU
(``parallel.spawn_ranks``): bytes and counts do not depend on the device.
The CPU is asked for with --cpu (or CMFEM_FORCE_CPU=1); without it the
module refuses to run.
Beside the counted bytes stand the analytic halo of the z split,
2 * NXd * NYd * itemsize per neighbouring pair and apply, and the JAX
study's HLO counts at N = 8 (``JAX_N8``).  No time is projected.

    python -m cmfem_tpu_torch.scripts.comms_model [2 4 8] --cpu
        [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d

# The JAX study's figures at N = 8, from the JAX package's
# artifacts_comms_model.json (collectives parsed from its compiled HLO on a
# virtual CPU mesh): bytes and counts, not times.
JAX_N8 = {
    "sumfact_per_apply": {"count": 2, "bytes": 2312,
                          "ops": "2 collective-permutes of f32[17, 17]"},
    "dofpart_cg_per_iteration": {
        "count": 3, "bytes": 2644,
        "ops": "all-reduces of f32[220] and f64[220] (the interface halo) "
               "and of f32[1] (the dots, fused)"},
    "dofpart_cg_per_call": {"count": 4, "bytes": 5280},
    "dofpart_per_device_floats": 315,
    "dofpart_ndofs": 1957,
}


def _nbytes(t):
    return t.numel() * t.element_size()


class CollectiveLog:
    """Records the collectives and point-to-point ops of this process while
    active: ``records`` holds {"op", "dtype", "shape", "bytes"} per call
    (each op of a ``batch_isend_irecv`` as its isend or irecv)."""

    WRAPPED = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "isend", "irecv")

    def __init__(self):
        self.records = []
        self._saved = {}

    def _record(self, op, t, nbytes=None):
        self.records.append({"op": op, "dtype": str(t.dtype).split(".")[-1],
                             "shape": list(t.shape),
                             "bytes": _nbytes(t) if nbytes is None
                             else nbytes})

    def _wrap(self, name, orig):
        if name == "all_reduce":
            def fn(tensor, *a, **k):
                self._record(name, tensor)
                return orig(tensor, *a, **k)
        elif name == "all_gather":
            def fn(tensor_list, tensor, *a, **k):
                self._record(name, tensor, sum(map(_nbytes, tensor_list)))
                return orig(tensor_list, tensor, *a, **k)
        elif name == "all_gather_into_tensor":
            def fn(output, tensor, *a, **k):
                self._record(name, tensor, _nbytes(output))
                return orig(output, tensor, *a, **k)
        else:   # isend, irecv
            def fn(tensor, *a, **k):
                self._record(name, tensor)
                return orig(tensor, *a, **k)
        fn.__name__ = name
        return fn

    def __enter__(self):
        for name in self.WRAPPED:
            orig = getattr(c10d, name)
            self._saved[name] = orig
            fn = self._wrap(name, orig)
            # both names: P2POp and batch_isend_irecv check an op against
            # distributed_c10d's isend/irecv, the library calls dist.*
            setattr(c10d, name, fn)
            setattr(dist, name, fn)
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(c10d, name, orig)
            setattr(dist, name, orig)
        self._saved.clear()
        return False


def _classify(run, k1, k2):
    """Run ``run(k)`` for k = k1 and k2 under a log.  What the k2 run makes
    beyond the k1 run, over k2 - k1, is one unit's traffic: its ops (op,
    dtype, shape: count), count and bytes (by op); the rest of the k1 run is
    per-call (set-up and epilogue) traffic."""
    logs = []
    for k in (k1, k2):
        with CollectiveLog() as log:
            run(k)
        logs.append(collections.Counter(
            (r["op"], r["dtype"], tuple(r["shape"]), r["bytes"])
            for r in log.records))
    extra = logs[1] - logs[0]
    units = k2 - k1
    ops = {f"{op} {dt}{list(shape)}": n / units
           for (op, dt, shape, _), n in sorted(extra.items())}
    by_op = {}
    for (op, _, _, nb), n in extra.items():
        by_op[op] = by_op.get(op, 0) + nb * n / units
    count = sum(extra.values()) / units
    nbytes = sum(by_op.values())
    return {"per_unit_count": count, "per_unit_bytes": nbytes,
            "per_unit_bytes_by_op": by_op, "per_unit_ops": ops,
            "per_call_count": sum(logs[0].values()) - count * k1,
            "per_call_bytes": sum(nb * n for (*_, nb), n in logs[0].items())
            - nbytes * k1}


def rank_counts(n_devices):
    """On one rank of a gloo world of ``n_devices``: this rank's collective
    traffic per sharded sum-factorized apply and per DOF-partitioned CG
    iteration (numpy-friendly dict)."""
    from ..core import FESpace, make_cartesian_mesh_2d, make_cartesian_mesh_3d
    from ..ops import BilinearForm, SpaceOps
    from ..ops.sumfact_sharded import ShardedSumFactOperator
    from ..parallel import DofPartitionedOperator, make_device_mesh
    from ..solvers import cg

    cpu = torch.device("cpu")
    out = {"rank": dist.get_rank()}

    # z-sharded sum-factorized apply
    nx = ny = 8
    nz, order = 4 * n_devices, 2
    zmesh = make_device_mesh(n_devices, axis="z", device=cpu)
    fes = FESpace(make_cartesian_mesh_3d(nx, ny, nz), order)
    ops = SpaceOps(fes, quad_order=2 * order, device=cpu)
    data = (BilinearForm(ops).add_diffusion(0.1)
            .add_convection(np.array([1.0, -2.0, 0.5])).add_mass(1.0)
            ).assemble()
    shop = ShardedSumFactOperator(ops, data, nx, ny, nz, order, zmesh)
    u = shop.to_sharded(np.ones(fes.nscalar, np.float32))

    def applies_(k):
        for _ in range(k):
            shop(u)

    NXd, NYd = nx * order + 1, ny * order + 1
    out["sumfact"] = {**_classify(applies_, 1, 3),
                      "ndofs": fes.nscalar, "NXd": NXd, "NYd": NYd,
                      "itemsize": u.element_size()}

    # DOF-partitioned CG
    dmesh = make_device_mesh(n_devices, device=cpu)
    fes = FESpace(make_cartesian_mesh_2d(22, 22, geom="triangle"), 2)
    ops = SpaceOps(fes, quad_order=4, device=cpu, dtype=torch.float32)
    data = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1).assemble()
    dop = DofPartitionedOperator(ops, data, dmesh)
    b = dop.to_dist(np.ones(fes.nscalar, np.float32))

    def cg_(k):
        # rtol 0: every run takes exactly k iterations
        cg(dop, b, rtol=0.0, maxiter=k, dot=dop.dot, norm=dop.norm)

    out["dofpart_cg"] = {**_classify(cg_, 10, 20), "ndofs": fes.nscalar,
                         "n_interface": int(dop.n_interface),
                         "per_device_floats": int(dop.per_device_floats()),
                         "itemsize": b.element_size()}
    return out


def model(n_devices):
    """The study at one world size: every rank's counts and the totals."""
    from ..parallel import spawn_ranks

    ranks = spawn_ranks(rank_counts, n_devices, args=(n_devices,),
                        timeout=300.0)
    sf, dp = ranks[0]["sumfact"], ranks[0]["dofpart_cg"]
    analytic = 2 * sf["NXd"] * sf["NYd"] * sf["itemsize"]
    sent = [r["sumfact"]["per_unit_bytes_by_op"].get("isend", 0.0)
            for r in ranks]
    out = {
        "n_devices": n_devices,
        "z_sharded_sumfact": {
            "ndofs": sf["ndofs"],
            "per_apply_by_rank": [r["sumfact"]["per_unit_count"]
                                  for r in ranks],
            "sent_bytes_per_apply_by_rank": sent,
            "halo_bytes_per_apply_per_pair": sum(sent) / max(1,
                                                             n_devices - 1),
            "analytic_halo_bytes_per_apply": analytic,
            "per_call_bytes": max(r["sumfact"]["per_call_bytes"]
                                  for r in ranks),
            "ops_rank0": sf["per_unit_ops"],
        },
        "dofpart_cg": {
            "ndofs": dp["ndofs"], "n_interface": dp["n_interface"],
            "per_device_floats": max(r["dofpart_cg"]["per_device_floats"]
                                     for r in ranks),
            "per_iteration_count": dp["per_unit_count"],
            "per_iteration_bytes": dp["per_unit_bytes"],
            "expected_per_iteration_bytes":
                (2 * (dp["n_interface"] + 1) + 4) * dp["itemsize"],
            "per_call_count": dp["per_call_count"],
            "per_call_bytes": dp["per_call_bytes"],
            "ops": dp["per_unit_ops"],
            "same_on_every_rank": all(
                r["dofpart_cg"]["per_unit_bytes"] == dp["per_unit_bytes"]
                for r in ranks),
        },
    }
    return out


DIFFERENCES = [
    "z split: the halo goes point to point (batch_isend_irecv: an isend and "
    "an irecv of one (NYd, NXd) plane per neighbour), where the JAX program "
    "has two collective-permutes of one plane on every device; an end rank "
    "of the port sends one plane, an interior rank two, so per neighbouring "
    "pair and apply both move 2 * NXd * NYd * itemsize",
    "DOF partition: each CG iteration makes 6 all_reduces: the operator's "
    "two interface halos of n_interface + 1 floats (the last slot is the "
    "dead one of padded maps) and 4 scalar dots or norms, each reduced on "
    "its own; the JAX program has 3 (the two halos, of which one in float64 "
    "by promotion, and the dots fused into one)",
    "the port runs float32 throughout; JAX's assembled data stays float64",
    "ranks are processes with one slab each; JAX's are devices of one "
    "program",
]


def main(argv=None):
    from .common import add_run_args, cpu_only, out_dir, write_json

    ap = add_run_args(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("world_sizes", nargs="*", type=int, default=[2, 4, 8])
    args = ap.parse_args(argv)
    cpu_only(args.cpu, "comms_model counts on gloo CPU ranks")

    art = {"method": "collectives counted at their torch.distributed calls "
                     "on gloo CPU ranks (CollectiveLog); per-apply and "
                     "per-iteration figures from runs of two lengths",
           "jax_n8": JAX_N8, "differences": DIFFERENCES,
           "by_world_size": [model(n) for n in args.world_sizes]}
    print(json.dumps(art["by_world_size"]))
    path = write_json(os.path.join(out_dir(args.out_dir, "comms_model"),
                                   "comms_model.json"), art)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
