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
]
