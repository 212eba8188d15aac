"""Port of theoremsearch_tpu.core (see the package docstring)."""

from .meshes import Mesh, make_mesh, shard_axis_size

__all__ = ["Mesh", "make_mesh", "shard_axis_size"]
