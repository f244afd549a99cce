"""The ``"shard"`` mesh over ``torch.distributed`` ranks and the collectives
of the BESS scheme (counterpart of ``besskge_tpu/parallel``)."""

from besskge_tpu_torch.parallel.mesh import (  # noqa: F401
    ShardMesh,
    batch_partition_specs,
    make_shard_mesh,
    param_partition_specs,
    shard_batch,
    shard_params,
)
