"""Port of theoremsearch_tpu.core (see the package docstring)."""

from .config import EncoderConfig, IndexConfig, MeshConfig, SearchConfig
from .meshes import Mesh, make_mesh, shard_axis_size

__all__ = [
    "IndexConfig",
    "EncoderConfig",
    "SearchConfig",
    "MeshConfig",
    "Mesh",
    "make_mesh",
    "shard_axis_size",
]
