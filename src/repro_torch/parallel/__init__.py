"""Device meshes.  The LM mesh: ``ShardingPlan`` over a ``DeviceMesh``
(``make_plan``, ``choose_attn_mode``, DTensor ``placements``), the ambient
mesh and its logical-axis constraints.  The overlay mesh: ``MeshSpec``
placement, mesh realization, the app- and row-sharded executor wrappers
and the frame sharding."""

from repro_torch.parallel.axes import (
    APP_AXIS, ROW_AXIS, Mesh, MeshSpec, ShardedFrames, ambient_mesh, app_mesh, build_mesh,
    constrain, constrain_time_mixer, halo_exchange_rows, lm_mesh, local_devices, shard_apps,
    shard_apps_rows, shard_pipeline_rows,
)
from repro_torch.parallel.sharding import (
    FrameSharding, NamedSharding, P, ShardingPlan, choose_attn_mode, frame_sharding,
    make_plan, place, placements,
)

__all__ = [
    "APP_AXIS", "FrameSharding", "Mesh", "MeshSpec", "NamedSharding", "P", "ROW_AXIS",
    "ShardedFrames", "ShardingPlan", "ambient_mesh", "app_mesh", "build_mesh",
    "choose_attn_mode", "constrain", "constrain_time_mixer", "frame_sharding",
    "halo_exchange_rows", "lm_mesh", "local_devices", "make_plan", "place", "placements",
    "shard_apps", "shard_apps_rows", "shard_pipeline_rows",
]
