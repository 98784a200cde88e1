"""Distribution: logical-axis sharding rules, the mesh context and
``constrain`` on DTensors, the deep grid's (tile-row x batch) shard specs,
data and pipeline parallelism (the counterpart of ``repro.parallel``).  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` over an initialised process group; every rank runs the
same program."""

from repro_torch.parallel.pipeline import bubble_fraction, pipeline_forward
from repro_torch.parallel.sharding import (
    ShardingRules,
    TileGridShardSpecs,
    active_mesh,
    constrain,
    data_parallel,
    default_rules,
    logical_spec,
    named_sharding,
    placements,
    set_rules,
    tile_grid_shard_specs,
    use_mesh_and_rules,
)

__all__ = [
    "ShardingRules", "TileGridShardSpecs", "active_mesh", "bubble_fraction",
    "constrain", "data_parallel", "default_rules", "logical_spec",
    "named_sharding", "pipeline_forward", "placements", "set_rules",
    "tile_grid_shard_specs", "use_mesh_and_rules",
]
