"""The multi-device frame: (dp, sp) grids of ``torch.distributed`` ranks."""

from .sharded import (  # noqa: F401
    Mesh,
    ShardedFrameOutput,
    compiled_sharded_frame,
    make_mesh,
    render_frame_sharded,
    render_shadow_atlas_sharded,
    sharded_config,
)
