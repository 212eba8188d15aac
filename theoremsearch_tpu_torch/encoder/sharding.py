"""Parameter placement over a (data, shard) mesh, and the tensor-parallel
pieces the three towers' forwards share (port of
theoremsearch_tpu/encoder/sharding.py).

Each family module (model.py / gemma.py / bert.py) owns its rules: a
tree shaped as its params, one spec a leaf in `PartitionSpec`'s order,
e.g. `(None, "shard")` (column-sharded), `("shard", None)` (row-sharded),
`("shard",)` or `(None,)`. `place_params` walks params and rules
together, keeping exactly the keys the params carry (a headless gemma
checkpoint has no ST head).

The reference places a leaf with `jax.device_put` and lets GSPMD insert
the collectives. The port writes them out:

- a sharded leaf is a `ShardedTensor`: the pieces this process holds, one
  a shard of the mesh's home data row (the first; across processes, the
  first this process holds), with their global piece indices, split along
  one axis (only where the axis divides, as `jax.device_put` demands);
- a replicated leaf is one tensor on the mesh's first device;
- data row r of the mesh reads `row_params(params, mesh, r)`, the same
  tree copied to its devices by differentiable `.to` copies, so autograd
  sums a leaf's gradient over the rows this process runs (the
  reference's dp psum) and over the shards that read a replicated leaf.

Across processes each process places the params on its own home row and
keeps replicas for its own rows only; the train step sums the gradients
over the column group (`train/contrastive.py`). Where a data row spans
several processes, each holds a block of the row's pieces, and the
row's collectives run over the mesh's row group.

A tensor-parallel forward (`TP`) multiplies the replicated activation by
each shard's column block, sums the row-sharded products (the reference's
psum) and runs the replicated work (norms, residual adds, pooling) on the
first device. On a row split over processes it is SPMD, as Megatron-LM
is: every process of the row holds the replicated activations and runs
the replicated work itself, and the sums, the gathered attention core's
gather and the gradients of replicated inputs go through the row's
autograd collectives (`core/distributed.py:row_bcast`, `row_reduce`,
`row_gather`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.distributed import all_gather, row_bcast, row_gather, row_reduce

__all__ = ["ShardedTensor", "TP", "is_sharded", "place_params", "row_params", "unshard_params"]


class ShardedTensor:
    """One logical parameter of shape `shape`, split along `dim` into
    `count` equal pieces, of which this process holds `pieces`: piece
    `index[i]` is `pieces[i]`, on its shard's device.

    pieces: the tensors, in shard order; dim: the split axis; mesh: the
    mesh the pieces were placed on; index: their global piece indices;
    count: the global piece count. A process whose data row spans other
    processes holds a contiguous block of indices, and `full` gathers the
    rest over the mesh's row group."""

    def __init__(self, pieces: Sequence[torch.Tensor], dim: int, mesh, index: Sequence[int],
                 count: int):
        self.pieces = list(pieces)
        self.dim = dim
        self.mesh = mesh
        self.index = list(index)
        self.count = count

    @property
    def split_over_processes(self) -> bool:
        """Whether other processes hold some of the pieces."""
        return len(self.pieces) < self.count

    @property
    def shape(self) -> torch.Size:
        """The logical (global) shape."""
        s = list(self.pieces[0].shape)
        s[self.dim] *= self.count
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def ndim(self) -> int:
        return self.pieces[0].ndim

    @property
    def devices(self) -> list[torch.device]:
        return [p.device for p in self.pieces]

    @property
    def device(self) -> torch.device:
        """The first local shard's device: where the leaf's full form goes."""
        return self.pieces[0].device

    def with_pieces(self, pieces: Sequence[torch.Tensor]) -> "ShardedTensor":
        """Other tensors split as this leaf is (the same indices)."""
        return ShardedTensor(pieces, self.dim, self.mesh, self.index, self.count)

    def map(self, fn) -> "ShardedTensor":
        """fn applied to every piece, the split kept."""
        return self.with_pieces([fn(p) for p in self.pieces])

    def blocks(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A replicated tensor of this leaf's logical shape cut as this
        leaf is: the local blocks, differentiable. On a row split over
        processes `x`'s gradient is summed over the row (each process's
        blocks read only part of it)."""
        if self.split_over_processes:
            x = row_bcast(x, self.mesh.row_group)
        parts = torch.tensor_split(x, self.count, dim=self.dim)
        return [parts[i] for i in self.index]

    def split(self, full: torch.Tensor) -> "ShardedTensor":
        """`full` (this leaf's logical shape) split as this leaf is, each
        local piece a fresh contiguous tensor on its shard's device."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"cannot split {tuple(full.shape)} as a {tuple(self.shape)} leaf")
        blocks = torch.tensor_split(full, self.count, dim=self.dim)
        return self.with_pieces([_fresh(blocks[i], p.device) for i, p in zip(self.index, self.pieces)])

    def full(self, device=None) -> torch.Tensor:
        """The pieces concatenated on `device` (default: the first local
        shard's). On a row split over processes the other processes'
        pieces come over the row group, gathered on the first local
        shard's device before the move (NCCL takes no host tensor): every
        process of the row calls it."""
        if not self.split_over_processes:
            device = self.device if device is None else device
            return torch.cat([p.to(device) for p in self.pieces], dim=self.dim)
        local = torch.cat([p.to(self.device) for p in self.pieces], dim=self.dim)
        out = torch.cat(all_gather(local, self.mesh.row_group), dim=self.dim)
        return out if device is None else out.to(device)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, dim={self.dim}, "
                f"pieces={self.index} of {self.count})")


def _fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device` that shares no storage with it
    (a column block is a strided view of its matrix; a row block a view)."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _shard_axis(spec: tuple, mesh) -> int | None:
    """The axis a spec shards over the mesh's shard axis, or None for a
    replicated leaf."""
    shard_name = mesh.axis_names[1]
    axis = None
    for i, name in enumerate(spec):
        if name is None:
            continue
        if name != shard_name:
            raise ValueError(f"spec {spec}: the port shards parameters over the mesh's "
                             f"{shard_name!r} axis only, not {name!r}")
        if axis is not None:
            raise ValueError(f"spec {spec} names {name!r} twice")
        axis = i
    return axis


def _place(t: torch.Tensor, spec: tuple, mesh):
    spec = tuple(spec)
    if len(spec) != t.ndim:
        raise ValueError(f"spec {spec} does not fit a {t.ndim}-D leaf")
    axis = _shard_axis(spec, mesh)
    if axis is None:
        return _fresh(t, mesh.first_device)
    n = mesh.shape[mesh.axis_names[1]]
    if t.shape[axis] % n:
        raise ValueError(
            f"the sharding {spec} over a {n}-way {mesh.axis_names[1]!r} axis implies that the "
            f"global size of its dimension {axis} should be divisible by {n}, but it is equal "
            f"to {t.shape[axis]} (full shape: {tuple(t.shape)})")
    blocks = torch.tensor_split(t, n, dim=axis)
    mine = mesh.local_shards
    return ShardedTensor([_fresh(blocks[s], d) for s, d in mine], axis, mesh,
                         index=[s for s, _ in mine], count=n)


def place_params(params: dict, rules: dict, mesh) -> dict:
    """Place a {tensors..., 'layers': [dict, ...]} tree on the mesh by a
    same-shaped rules tree of specs: fresh copies of the pieces this
    process holds, the input untouched."""
    out = {k: _place(v, rules[k], mesh) for k, v in params.items() if k != "layers"}
    out["layers"] = [
        {name: _place(val, rules["layers"][name], mesh) for name, val in layer.items()}
        for layer in params["layers"]
    ]
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def unshard_params(tree, device=None):
    """Every ShardedTensor of `tree` concatenated into one tensor on
    `device` (default: its first shard's device; gathered over the row
    group where the row spans processes, so every process of the row
    calls it); other leaves copied there too when a device is given."""
    def full(x):
        if isinstance(x, ShardedTensor):
            return x.full(device)
        if isinstance(x, torch.Tensor) and device is not None:
            return x.to(device)
        return x
    return _tree_map(full, tree)


def is_sharded(params) -> bool:
    """Whether a tower's params were placed by `shard_params` (the
    embedding is sharded under every tower's rules)."""
    return isinstance(params, dict) and isinstance(params.get("embed"), ShardedTensor)


def row_params(params, mesh, row: int):
    """The params as data row `row` of the mesh reads them: each piece
    copied to its shard's device in that row, each replicated leaf to the
    row's first device, by differentiable copies (a copy to the device a
    tensor is on is the tensor itself). The home row (row 0 in one
    process) is the placement itself."""
    if row == mesh.home_row:
        return params
    devs = list(mesh.devices[row])

    def move(x):
        if isinstance(x, ShardedTensor):
            return x.with_pieces([p.to(devs[i]) for p, i in zip(x.pieces, x.index)])
        if isinstance(x, torch.Tensor):
            return x.to(devs[0])
        return x
    return _tree_map(move, params)


class TP:
    """The collectives of one tensor-parallel forward over the shards of
    one data row that sharded leaf `w`'s pieces live on (a row view of the
    params is on its row's devices): `devices` this process's shard
    devices, the first holding the replicated activations; `index` their
    global shard indices, `n` the row's shard count; `group` the mesh's
    row group when the row spans processes (None when this process holds
    it whole)."""

    def __init__(self, w: ShardedTensor):
        self.devices = w.devices
        self.first = self.devices[0]
        self.index = w.index
        self.n = w.count
        self.group = w.mesh.row_group if w.split_over_processes else None

    def rep(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor (an activation or a leaf) that per-shard work
        reads: on a row split over processes its gradient is summed over
        the row (`row_bcast`); else `x` itself."""
        return x if self.group is None else row_bcast(x, self.group)

    def bcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A replicated activation (or leaf) as each local shard reads it: a
        copy on each shard's device, or a view where the device repeats, so
        each shard's uses add up apart before the shards' gradients are
        summed, as across devices or processes."""
        x = self.rep(x)
        return [x.view_as(x) if d == x.device else x.to(d) for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """Column blocks concatenated on the first device; across processes
        every process of the row gets every block (`row_gather`)."""
        local = torch.cat([p.to(self.first) for p in parts], dim=dim)
        return local if self.group is None else row_gather(local, self.group, dim)

    def scatter(self, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
        """A tensor on the first device cut into n blocks along `dim`, the
        local shards' blocks on their devices (no collective: across
        processes the gradient of the rest comes from the other
        processes, through `gather`'s backward)."""
        blocks = torch.tensor_split(x, self.n, dim=dim)
        return [blocks[i].to(d) for i, d in zip(self.index, self.devices)]

    def split(self, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
        """A replicated leaf's local blocks along `dim` (`scatter` of
        `rep(x)`: its gradient whole on every process of the row)."""
        return self.scatter(self.rep(x), dim)

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of per-shard partials on the first device, accumulated in
        f32, or in the partials' own dtype where it is wider (an f64 forward
        is not rounded to f32, as the reference's psum keeps its dtype):
        the local partials, then over the row's processes; cast back once
        (the psum after a row-sharded product)."""
        wide = torch.promote_types(parts[0].dtype, torch.float32)
        acc = parts[0].to(wide)
        for p in parts[1:]:
            acc = acc + p.to(self.first, wide)
        if self.group is not None:
            acc = row_reduce(acc, self.group)
        return acc.to(parts[0].dtype)

    def col(self, xs: Sequence[torch.Tensor], w: ShardedTensor,
            b: ShardedTensor | None = None) -> list[torch.Tensor]:
        """Each shard's replicated input times its column block of `w`
        (plus its block of the column bias `b`, cast to the input's dtype)."""
        out = [x @ p for x, p in zip(xs, w.pieces)]
        if b is not None:
            out = [o + bp.to(o.dtype) for o, bp in zip(out, b.pieces)]
        return out

    def row(self, parts: Sequence[torch.Tensor], w: ShardedTensor) -> torch.Tensor:
        """Each shard's column block of the activation times its row block
        of `w`, the partials reduced on the first device."""
        return self.reduce([p @ wp for p, wp in zip(parts, w.pieces)])

    def attention(self, q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                  v: Sequence[torch.Tensor], kv_heads: int, core) -> list[torch.Tensor]:
        """The attention core over column-sharded q/k/v, as column blocks of
        its output (what the row-sharded wo takes).

        Head-local where `kv_heads` divides over the shards: a column block
        is then whole heads, and shard s's q heads are the ones grouped
        with its kv heads, so each local shard runs `core(q, k, v, device,
        n)` on its heads (the tower's head counts divided by n). Otherwise
        the blocks are gathered on the first device (across processes on
        every process of the row), `core(..., first, 1)` runs over all
        heads there, and its output is cut into the local column blocks.
        Either way the core is the tower's own (the kernels on the card);
        a replicated leaf it reads goes through `rep`."""
        if kv_heads % self.n == 0:
            return [core(qi, ki, vi, d, self.n) for qi, ki, vi, d in zip(q, k, v, self.devices)]
        return self.scatter(core(self.gather(q), self.gather(k), self.gather(v), self.first, 1))

    def embed(self, table: ShardedTensor, ids: torch.Tensor) -> torch.Tensor:
        """A vocab-sharded lookup: each local shard gathers the ids in its
        global row range (zeros elsewhere), the partials summed on the
        first device and over the row's processes; exactly one shard
        contributes a token, so the sum is exact."""
        rows_a_piece = table.pieces[0].shape[0]
        parts = []
        for p, i, d in zip(table.pieces, self.index, self.devices):
            local = ids.to(d).long() - i * rows_a_piece
            hit = (local >= 0) & (local < p.shape[0])
            rows = p[local.clamp(0, p.shape[0] - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=p.dtype, device=d)))
        out = parts[0]
        for part in parts[1:]:
            out = out + part.to(self.first)
        return out if self.group is None else row_reduce(out, self.group)
