"""Device mesh construction (port of theoremsearch_tpu/core/meshes.py).

The reference runs one controller over a JAX `Mesh` with `shard_map` and
`all_gather`. The port keeps that shape: a mesh is a (data, shard) grid
of `torch.device`s; a sharded array is one tensor per shard on that
shard's device, each shard's kernel runs on its device's current stream,
and per-shard results are copied to the mesh's first device and merged
there (the `all_gather`).

- ``shard`` axis: the corpus rows are partitioned across devices; each
  scans its rows and the per-shard top-k lists are merged.
- ``data`` axis: encoder batches are split across devices.

Unlike a JAX mesh, a device may appear more than once: a mesh of
repeated "cpu" devices runs the sharded code on the CPU (torch has no
virtual CPU devices), and [cuda:0] * 4 runs four shards on one card.

Across processes (after `core/distributed.py:initialize`), every process
passes its own local devices and the grid is filled row-major by the
processes' devices in rank order, as `jax.devices()` orders them. A
process holds only its own grid positions (the others are None in
`devices`) and its own first device is `first_device`. Two layouts are
supported (`distributed.process_layout`): whole data rows a process, or
every data row split into equal blocks of whole processes. Two subgroups
of the process group carry the collectives:

- the row group (`row_group`): the processes of this process's data row,
  when it spans several: the engines gather their per-shard top-k lists
  over it and a tensor-parallel forward sums its partials over it;
- the column group (`column_group`): the processes that hold the same
  block of shards in every data row (every process, when each holds whole
  rows): the dp encode and the train step gather their rows over it, and
  the train step sums its gradients over it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import distributed
from .config import MeshConfig


class Mesh:
    """A (data, shard) grid of devices with named axes.

    devices: object array of torch.device, shape (data, shard); None at
    the positions other processes hold. axis_names: (data axis, shard
    axis); shape: {axis name: size}. process_group: the
    `distributed.ProcessGroup` the grid spans, or None for a mesh of this
    process's devices alone; local: bool array of the positions this
    process holds; layout: "local", "data" or "shard"
    (`distributed.process_layout`). row_group / column_group: the
    subgroups of the module docstring, or None where there is no other
    process to reach (`mesh_groups` gives them; `make_mesh` passes them)."""

    def __init__(self, devices, axis_names=("data", "shard"), process_group=None, local=None,
                 layout: str = "local", row_group=None, column_group=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = None if src[pos] is None else resolve_device(src[pos])
        if arr.ndim != 2 or len(axis_names) != 2:
            raise ValueError(f"a mesh is a 2-D (data, shard) grid, got shape {arr.shape}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.process_group = process_group
        self.local = (np.ones(arr.shape, bool) if local is None
                      else np.asarray(local, bool).reshape(arr.shape))
        self.layout = layout
        self.process_index = process_group.rank if process_group is not None else 0
        self.process_count = process_group.size if process_group is not None else 1
        self.row_group = row_group
        self.column_group = column_group

    @property
    def home_row(self) -> int:
        """The first data row this process holds a position of: where its
        params are placed and its engines' shards live."""
        return int(np.nonzero(self.local.any(axis=1))[0][0])

    @property
    def local_rows(self) -> list[int]:
        """The data rows this process runs, in order: those it holds whole,
        or the one whose block of shards it holds."""
        return [int(r) for r in np.nonzero(self.local.any(axis=1))[0]]

    @property
    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of this process's positions in its
        home row, in shard order."""
        r = self.home_row
        return [(s, self.devices[r, s]) for s in range(self.devices.shape[1]) if self.local[r, s]]

    @property
    def shard_devices(self) -> list[torch.device]:
        """This process's devices along the shard axis of its home row (the
        whole first row in one process; `local_shards` gives their global
        shard indices)."""
        return [d for _, d in self.local_shards]

    @property
    def data_devices(self) -> list[torch.device]:
        """This process's first device of each data row it runs."""
        return [self.devices[r][self.local[r]][0] for r in self.local_rows]

    @property
    def first_device(self) -> torch.device:
        """Where this process gathers and merges per-shard results."""
        return self.local_shards[0][1]

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_group is not None else "")
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{procs})")


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """Build a 2-D (data, shard) mesh.

    devices: a list of devices (names or torch.device; repeats allowed).
    None means every visible card, and raises without CUDA, like every
    entry point of the port. If `cfg` is None, every device goes on the
    shard axis (the layout for a corpus bigger than one device).

    After `distributed.initialize`, `devices` are this process's own,
    every process passes as many, and the grid is the global one: the
    processes' devices in rank order, row-major; a split
    `distributed.process_layout` refuses raises; `mesh_groups` gives the
    row and column groups. (`Mesh(grid)` builds a mesh of this process's
    devices alone at any time.)"""
    if devices is None:
        resolve_device(None)          # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    pg = distributed.current()
    n_proc = pg.size if pg is not None else 1
    if cfg is None:
        cfg = MeshConfig(data=1, shard=len(devices) * n_proc)
    if cfg.data < 1 or cfg.shard < 1:
        raise ValueError(f"mesh axes must be positive, got {cfg.data}x{cfg.shard}")
    n = cfg.data * cfg.shard
    names = (cfg.data_axis, cfg.shard_axis)
    if pg is None:
        if n > len(devices):
            raise ValueError(f"mesh {cfg.data}x{cfg.shard} needs {n} devices, have {len(devices)}")
        grid = np.empty((cfg.data, cfg.shard), dtype=object)
        for i, d in enumerate(devices[:n]):
            grid[i // cfg.shard, i % cfg.shard] = d
        return Mesh(grid, axis_names=names)
    counts = distributed.all_gather(torch.tensor([len(devices)], device=pg.device), pg)
    if any(int(c) != len(devices) for c in counts):
        raise ValueError(f"every process must pass as many local devices; got "
                         f"{[int(c) for c in counts]}")
    layout = distributed.process_layout(cfg.data, cfg.shard, len(devices), n_proc)
    grid = np.empty(n, dtype=object)
    local = np.zeros(n, bool)
    lo = pg.rank * len(devices)
    grid[lo : lo + len(devices)] = devices
    local[lo : lo + len(devices)] = True
    row_group, column_group = mesh_groups(layout, cfg.data, cfg.shard, len(devices), pg)
    return Mesh(grid.reshape(cfg.data, cfg.shard), axis_names=names, process_group=pg,
                local=local.reshape(cfg.data, cfg.shard), layout=layout, row_group=row_group,
                column_group=column_group)


def mesh_groups(layout: str, data: int, shard: int, n_local: int,
                pg: "distributed.ProcessGroup") -> tuple:
    """(row group, column group) of process `pg.rank` on a (data, shard)
    grid of `layout` (`distributed.process_layout`), None where the group
    would hold this process alone:

    - "local" (world size 1): both the one-process group, so its
      collectives still run (the NCCL world-1 run);
    - "data": no row group; the column group is every process;
    - "shard" at data 1: the row group is every process; no column group;
    - "shard" at data > 1: subgroups (`distributed.subgroup`); every
      process creates every row group, then every column group, in the
      same order, as `new_group` requires."""
    if layout == "local":
        return pg, pg
    if layout == "data":
        return None, pg
    if data == 1:
        return pg, None
    per_row = shard // n_local
    rows = [distributed.subgroup(range(r * per_row, (r + 1) * per_row)) for r in range(data)]
    cols = [distributed.subgroup(range(c, pg.size, per_row)) for c in range(per_row)]
    return rows[pg.rank // per_row], cols[pg.rank % per_row]


def shard_axis_size(mesh: Mesh, axis: str = "shard") -> int:
    return mesh.shape[axis]


def gather_shard_lists(mesh: Mesh, lists: list, b: int, width: int, device) -> list:
    """Per-shard top-k lists of the home row, in global shard order.

    lists: one (scores (b, width) f32, ids (b, width) int) or None a local
    shard, in `local_shards` order. Without a row group these are every
    shard's and come back as they are. With one, they are exchanged in a
    single all_gather over the row (scores and ids packed as int32 words)
    and one entry a shard of the row comes back, on `device`; an entry a
    process passed as None holds zeros (the caller knows which shards are
    empty from replicated state). Every data row runs the same search (the
    reference replicates `data`), each over its own row group."""
    pg = mesh.row_group
    if pg is None:
        return lists
    id_dtype = next((i.dtype for _, i in filter(None, lists)), torch.int32)
    zeros = torch.zeros((2, b, width), dtype=torch.int32, device=device)
    packed = torch.stack([
        zeros if e is None else torch.stack([e[0].float().contiguous().view(torch.int32),
                                             e[1].to(torch.int32)])
        for e in lists])
    out = torch.cat(distributed.all_gather(packed, pg))
    return [(o[0].view(torch.float32), o[1].to(id_dtype)) for o in out]
