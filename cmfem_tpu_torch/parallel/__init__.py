"""The distributed paths on ``torch.distributed`` (port of
``cmfem_tpu/parallel``): the operator layer.

``launch`` starts a world of ranks (NCCL on the card, gloo on CPU
processes); ``make_device_mesh`` is the counterpart of the JAX package's
``jax.sharding.Mesh``; ``ShardedPoissonApply`` splits the elements and
keeps vectors replicated; ``DofPartition``/``DofPartitionedOperator`` split
the DOFs as well (owned slabs and ghost halos); ``partition`` holds the RCB
element partition.  The z-split sum-factorized operator is
``ops.sumfact_sharded.ShardedSumFactOperator``.  The ablation layer:
``ShardedAblationNewton`` (elements split, (T, p) replicated) and
``DofPartitionedAblationNewton`` (the (T, p) vectors split as well), the
Newton iterate of the ablation drivers' ``sharding_devices`` and
``dof_partition`` options; ``io.checkpoint`` saves and restores their
per-rank slabs.
"""

from .ablation_dofpart import DofPartitionedAblationNewton
from .ablation_sharded import ShardedAblationNewton
from .dofpart import DofPartition, DofPartitionedOperator
from .launch import init_rank, spawn_ranks
from .sharding import (DeviceMesh, ShardedPoissonApply, make_device_mesh,
                       shard_elements)

__all__ = [
    "DeviceMesh",
    "DofPartition",
    "DofPartitionedAblationNewton",
    "DofPartitionedOperator",
    "ShardedAblationNewton",
    "ShardedPoissonApply",
    "init_rank",
    "make_device_mesh",
    "shard_elements",
    "spawn_ranks",
]
