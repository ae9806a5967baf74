from repro_torch.sharding.rules import (
    batch_spec,
    cache_specs,
    logical_to_mesh_axes,
    param_specs,
    shardings_for,
)
from repro_torch.sharding.compression import (
    compress_int8,
    decompress_int8,
    psum_compressed,
)

__all__ = [
    "batch_spec", "cache_specs", "logical_to_mesh_axes", "param_specs",
    "shardings_for", "compress_int8", "decompress_int8", "psum_compressed",
]
