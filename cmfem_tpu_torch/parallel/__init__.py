"""The distributed paths on ``torch.distributed`` (port of
``cmfem_tpu/parallel``): the operator layer.

``launch`` starts a world of ranks (NCCL on the card, gloo on CPU
processes); ``make_device_mesh`` is the counterpart of the JAX package's
``jax.sharding.Mesh``; ``ShardedPoissonApply`` splits the elements and
keeps vectors replicated; ``DofPartition``/``DofPartitionedOperator`` split
the DOFs as well (owned slabs and ghost halos); ``partition`` holds the RCB
element partition.  The z-split sum-factorized operator is
``ops.sumfact_sharded.ShardedSumFactOperator``.  The distributed ablation
Newton classes of the JAX package (``ShardedAblationNewton``,
``DofPartitionedAblationNewton``) come with the ablation layer, ROADMAP
item 18b, and are not here yet.
"""

from .dofpart import DofPartition, DofPartitionedOperator
from .launch import init_rank, spawn_ranks
from .sharding import (DeviceMesh, ShardedPoissonApply, make_device_mesh,
                       shard_elements)

__all__ = [
    "DeviceMesh",
    "DofPartition",
    "DofPartitionedOperator",
    "ShardedPoissonApply",
    "init_rank",
    "make_device_mesh",
    "shard_elements",
    "spawn_ranks",
]
