"""Multi-device execution: meshes, sharded sweeps and the multi-process
runtime (counterpart of `guided_vae_nmf_tpu/parallel/`)."""

from . import multihost
from .mesh import (
    LocalGroup,
    Mesh,
    ShardError,
    data_parallel_mesh,
    make_mesh,
    maybe_mesh,
    pad_to_multiple,
    replicate,
    row_slices,
    run_shards,
    shard_batch,
)
from .sweep import (
    frame_sharded_mcem,
    grid_sharded_mcem,
    shard_file_list,
    sharded_mcem_fused,
    sharded_mcem_m1,
    sharded_mcem_m2,
)

__all__ = [
    "LocalGroup", "Mesh", "ShardError", "data_parallel_mesh",
    "frame_sharded_mcem", "grid_sharded_mcem", "make_mesh", "maybe_mesh",
    "multihost", "pad_to_multiple", "replicate", "row_slices", "run_shards",
    "shard_batch", "shard_file_list", "sharded_mcem_fused",
    "sharded_mcem_m1", "sharded_mcem_m2",
]
