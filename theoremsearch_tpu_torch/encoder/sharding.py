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
the collectives. The port keeps one controller and writes them out:

- a sharded leaf is a `ShardedTensor`: one piece a shard, on that
  shard's device of the mesh's home data row (the first; across
  processes, the first this process holds), split along one axis (only
  where the axis divides, as `jax.device_put` demands);
- a replicated leaf is one tensor on the mesh's first device;
- data row r of the mesh reads `row_params(params, mesh, r)`, the same
  tree copied to its devices by differentiable `.to` copies, so autograd
  sums a leaf's gradient over the rows (the reference's dp psum) and over
  the shards that read a replicated leaf.

Across processes each process places the params on its own home row and
keeps replicas for its own rows only; the train step sums the gradients
over the processes (`train/contrastive.py`). A data row whose shards
span processes would need the tp collectives across processes, which
are not ported: placing params on such a mesh raises NotImplementedError.

A tensor-parallel forward (`TP`) multiplies the replicated activation by
each shard's column block, reduces the row-sharded products on the row's
first device (the reference's psum) and runs the replicated work (norms,
residual adds, pooling) there once.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ShardedTensor", "TP", "is_sharded", "place_params", "row_params", "unshard_params"]


class ShardedTensor:
    """One logical parameter of shape `shape`, split along `dim` into
    `len(pieces)` equal pieces, piece s on shard s's device.

    pieces: the tensors, in shard order; dim: the split axis; mesh: the
    mesh the pieces were placed on (None for a row view's copies that
    need none)."""

    def __init__(self, pieces: Sequence[torch.Tensor], dim: int, mesh=None):
        self.pieces = list(pieces)
        self.dim = dim
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        s = list(self.pieces[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.pieces)
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
        """The first shard's device: where the leaf's full form goes."""
        return self.pieces[0].device

    def map(self, fn) -> "ShardedTensor":
        """fn applied to every piece, the split kept."""
        return ShardedTensor([fn(p) for p in self.pieces], self.dim, self.mesh)

    def split(self, full: torch.Tensor) -> "ShardedTensor":
        """`full` (this leaf's logical shape) split as this leaf is, each
        piece a fresh contiguous tensor on its shard's device."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"cannot split {tuple(full.shape)} as a {tuple(self.shape)} leaf")
        blocks = torch.tensor_split(full, len(self.pieces), dim=self.dim)
        return ShardedTensor([_fresh(b, p.device) for b, p in zip(blocks, self.pieces)],
                             self.dim, self.mesh)

    def full(self, device=None) -> torch.Tensor:
        """The pieces concatenated on `device` (default: the first shard's)."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([p.to(device) for p in self.pieces], dim=self.dim)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, dim={self.dim}, "
                f"pieces={len(self.pieces)})")


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
    return ShardedTensor([_fresh(b, d) for b, d in zip(blocks, mesh.shard_devices)], axis, mesh)


def place_params(params: dict, rules: dict, mesh) -> dict:
    """Place a {tensors..., 'layers': [dict, ...]} tree on the mesh by a
    same-shaped rules tree of specs: fresh copies, the input untouched.
    A mesh whose data row spans processes raises NotImplementedError."""
    mesh.require_whole_rows("tensor-parallel params")
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
    `device` (default: its first shard's device); other leaves copied
    there too when a device is given."""
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
            return ShardedTensor([p.to(d) for p, d in zip(x.pieces, devs)], x.dim, x.mesh)
        if isinstance(x, torch.Tensor):
            return x.to(devs[0])
        return x
    return _tree_map(move, params)


class TP:
    """The collectives of one tensor-parallel forward over the shard
    devices of one data row (`w.devices` of any sharded leaf): the first
    device holds the replicated activations."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.first = self.devices[0]
        self.n = len(self.devices)

    def bcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A replicated activation (or leaf) as each shard reads it."""
        return [x.to(d) for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """Column blocks concatenated on the first device."""
        return torch.cat([p.to(self.first) for p in parts], dim=dim)

    def scatter(self, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
        """A tensor on the first device cut into n blocks along `dim`, one
        a shard."""
        return [b.to(d) for b, d in zip(torch.tensor_split(x, self.n, dim=dim), self.devices)]

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of per-shard partials on the first device, accumulated in
        f32 and cast back once (the psum after a row-sharded product)."""
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(self.first).float()
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
        with its kv heads, so each shard runs `core(q, k, v, device, n)`
        on its heads (the tower's head counts divided by n). Otherwise the
        blocks are gathered on the first device, `core(..., first, 1)` runs
        once over all heads there, and its output is cut into the column
        blocks. Either way the core is the tower's own (the kernels on the
        card)."""
        if kv_heads % self.n == 0:
            return [core(qi, ki, vi, d, self.n) for qi, ki, vi, d in zip(q, k, v, self.devices)]
        return self.scatter(core(self.gather(q), self.gather(k), self.gather(v), self.first, 1))

    def embed(self, table: ShardedTensor, ids: torch.Tensor) -> torch.Tensor:
        """A vocab-sharded lookup: each shard gathers the ids in its row
        range (zeros elsewhere), the partials summed on the first device;
        exactly one shard contributes a token, so the sum is exact."""
        parts, lo = [], 0
        for p, d in zip(table.pieces, self.devices):
            local = ids.to(d).long() - lo
            hit = (local >= 0) & (local < p.shape[0])
            rows = p[local.clamp(0, p.shape[0] - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=p.dtype, device=d)))
            lo += p.shape[0]
        out = parts[0]
        for part in parts[1:]:
            out = out + part.to(self.first)
        return out
