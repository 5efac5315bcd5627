"""The overlay device mesh: ``MeshSpec`` placement, mesh realization, the
app- and row-sharded executor wrappers and the frame sharding.  The LM
mesh (``ShardingPlan`` and friends) is ROADMAP Queue A item 6b."""

from repro_torch.parallel.axes import (
    APP_AXIS, ROW_AXIS, Mesh, MeshSpec, ShardedFrames, app_mesh, build_mesh,
    halo_exchange_rows, local_devices, shard_apps, shard_apps_rows,
    shard_pipeline_rows,
)
from repro_torch.parallel.sharding import FrameSharding, frame_sharding

__all__ = [
    "APP_AXIS", "FrameSharding", "Mesh", "MeshSpec", "ROW_AXIS", "ShardedFrames",
    "app_mesh", "build_mesh", "frame_sharding", "halo_exchange_rows",
    "local_devices", "shard_apps", "shard_apps_rows", "shard_pipeline_rows",
]
