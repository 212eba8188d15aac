"""Device mesh construction (port of theoremsearch_tpu/core/meshes.py).

The reference runs one controller over a JAX `Mesh` with `shard_map` and
`all_gather`. The port keeps that shape in one process: a mesh is a
(data, shard) grid of `torch.device`s; a sharded array is one tensor per
shard on that shard's device, each shard's kernel runs on its device's
current stream, and per-shard results are copied to the mesh's first
device and merged there (the `all_gather`).

- ``shard`` axis: the corpus rows are partitioned across devices; each
  scans its rows and the per-shard top-k lists are merged.
- ``data`` axis: encoder batches are split across devices.

Unlike a JAX mesh, a device may appear more than once: a mesh of
repeated "cpu" devices runs the sharded code on the CPU (torch has no
virtual CPU devices), and [cuda:0] * 4 runs four shards on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .config import MeshConfig


class Mesh:
    """A (data, shard) grid of devices with named axes.

    devices: object array of torch.device, shape (data, shard);
    axis_names: (data axis, shard axis); shape: {axis name: size}."""

    def __init__(self, devices, axis_names=("data", "shard")):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = resolve_device(src[pos])
        if arr.ndim != 2 or len(axis_names) != 2:
            raise ValueError(f"a mesh is a 2-D (data, shard) grid, got shape {arr.shape}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def shard_devices(self) -> list[torch.device]:
        """The devices along the shard axis (the first data row)."""
        return list(self.devices[0])

    @property
    def data_devices(self) -> list[torch.device]:
        """The devices along the data axis (the first shard column)."""
        return list(self.devices[:, 0])

    @property
    def first_device(self) -> torch.device:
        """Where per-shard results are gathered and merged."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """Build a 2-D (data, shard) mesh.

    devices: a list of devices (names or torch.device; repeats allowed).
    None means every visible card, and raises without CUDA, like every
    entry point of the port. If `cfg` is None, every device goes on the
    shard axis (the layout for a corpus bigger than one device)."""
    if devices is None:
        resolve_device(None)          # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if cfg is None:
        cfg = MeshConfig(data=1, shard=len(devices))
    if cfg.data < 1 or cfg.shard < 1:
        raise ValueError(f"mesh axes must be positive, got {cfg.data}x{cfg.shard}")
    n = cfg.data * cfg.shard
    if n > len(devices):
        raise ValueError(f"mesh {cfg.data}x{cfg.shard} needs {n} devices, have {len(devices)}")
    grid = np.empty((cfg.data, cfg.shard), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // cfg.shard, i % cfg.shard] = d
    return Mesh(grid, axis_names=(cfg.data_axis, cfg.shard_axis))


def shard_axis_size(mesh: Mesh, axis: str = "shard") -> int:
    return mesh.shape[axis]
