from tracer.kernels.leafcull import (
    CullTables,
    build_cull_tables,
    nearest_hit_feats,
    nearest_hit_leafcull,
    nearest_hit_leafcull_t,
    occluded_feats,
    occluded_leafcull,
)

__all__ = [
    "CullTables",
    "build_cull_tables",
    "nearest_hit_feats",
    "nearest_hit_leafcull",
    "nearest_hit_leafcull_t",
    "occluded_feats",
    "occluded_leafcull",
]
