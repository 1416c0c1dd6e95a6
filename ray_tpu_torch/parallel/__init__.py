from .mesh import (
    AXIS_ORDER,
    MeshSpec,
    P,
    PartitionSpec,
    ShardingRules,
    constrain,
    make_mesh,
    place,
    spec_placements,
    use_mesh,
)
from .pipeline import (
    make_gpipe_fn,
    make_pipelined_loss_fn,
    merge_microbatches,
    split_microbatches,
    stack_stage_params,
)
from .spmd import parallelize, shard_fn

__all__ = [
    "AXIS_ORDER",
    "MeshSpec",
    "P",
    "PartitionSpec",
    "ShardingRules",
    "make_mesh",
    "constrain",
    "place",
    "spec_placements",
    "use_mesh",
    "parallelize",
    "shard_fn",
    "make_gpipe_fn",
    "make_pipelined_loss_fn",
    "split_microbatches",
    "merge_microbatches",
    "stack_stage_params",
]
