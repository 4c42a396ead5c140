"""Multi-device rendering over torch.distributed (see parallel/sharding.py
for the design)."""

from .sharding import (  # noqa: F401
    Mesh,
    ShardedRenderer,
    gather_batch,
    make_mesh,
    merge_depth_gid,
    render_batch_sharded,
    render_scene_sharded,
)
