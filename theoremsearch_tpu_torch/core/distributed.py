"""Processes joined into one program: the port's counterpart of
`jax.distributed.initialize` and of the collectives XLA inserts when a
mesh spans processes (the reference's tests/multihost_worker.py).

    pg = initialize("tcp://10.0.0.1:29500", num_processes=2, process_id=r,
                    device="cuda:0")
    mesh = make_mesh(MeshConfig(shard=8), devices=local_devices)

`initialize` opens the process group; `core/meshes.py:make_mesh` then
builds the global (data, shard) grid from every process's local devices,
and the sharded paths (the engines' per-shard merge, the dp and tp
encodes, the dp + tp train step) reach the other processes only through
the collectives below, each given a `ProcessGroup` explicitly: the whole
group, or a subgroup of it (`subgroup`: the processes of one data row, or
those that hold the same shard block in every row).

- `all_gather` (rank order), `all_reduce_sum`, `all_reduce_flat` (one
  collective a dtype over a list of tensors), `broadcast`, `barrier`;
- `gather_rows`, an autograd gather for the train step: every process
  computes the same global loss from the gathered rows, so the backward
  returns each process's own slice of its own upstream gradient, with no
  reduction (a reduce-scatter would count every gradient world-size
  times); the parameter gradients are then summed over the processes;
- the four autograd collectives of a tensor-parallel forward over a data
  row split across processes (`encoder/sharding.py:TP`, in SPMD form:
  every process of the row runs the replicated work itself), each with
  the conjugate collective as its backward: `row_bcast` (identity; the
  gradient summed over the row), `row_reduce` (the sum over the row;
  identity), `row_gather` (the column blocks all-gathered; the gradient
  summed over the row and cut to the own block: a reduce-scatter, since
  every process's gathered core reads every block).

Transport: NCCL takes CUDA tensors as they are. Gloo takes host tensors,
so a CUDA tensor goes through a host copy and comes back to its device;
a gather moves raw bytes (any dtype, bit for bit). A sum of bf16 or f16
runs in f32 on either backend and is cast back once, so a sum does not
depend on the backend. This is the backend's transport, not a fallback:
a collective that fails raises, and a lost peer raises after the group's
timeout instead of hanging.

`stats` counts each collective's calls, the bytes this process sent into
it, the bytes staged through the host and the host seconds it took
(staging included; the Gloo path returns only once its result is back on
the device, so for it that is the collective's whole time). A staged
collective first waits for the work queued on its device, outside its
seconds, and splits them further: `pin_s` (allocating the pinned host
buffers), `to_host_s` (the device-side cast and the copy down) and
`to_device_s` (the copy back); the rest is the backend's own.

The backend follows the device unless the caller names one: the card
means "nccl" and "cpu" means "gloo". Gloo on the card is allowed when
asked for (NCCL refuses two ranks on one card); NCCL on the CPU is not.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["CollectiveStats", "ProcessGroup", "all_gather", "all_reduce_flat", "all_reduce_sum",
           "barrier", "broadcast", "current", "gather_rows", "initialize", "process_layout",
           "row_bcast", "row_gather", "row_reduce", "shutdown", "stats", "subgroup"]


@dataclass(frozen=True)
class ProcessGroup:
    """An open process group: torch's group object, this process's rank,
    the world size, the backend, the device this process runs on and the
    seconds a collective may wait for a peer (`initialize`'s timeout_s,
    which its subgroups keep)."""

    group: object
    rank: int
    size: int
    backend: str
    device: torch.device
    timeout_s: float


_current: ProcessGroup | None = None
# rank set -> this process's subgroup over it (None where it is no member)
_subgroups: dict[tuple[int, ...], "ProcessGroup | None"] = {}


class CollectiveStats:
    """Per collective: calls, payload bytes, host-staged bytes, seconds."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.by_op: dict[str, dict] = {}

    def _entry(self, op: str) -> dict:
        return self.by_op.setdefault(op, {"calls": 0, "bytes": 0, "staged_bytes": 0, "s": 0.0})

    def add(self, op: str, nbytes: int, staged: int, seconds: float) -> None:
        with self._lock:
            e = self._entry(op)
            e["calls"] += 1
            e["bytes"] += nbytes
            e["staged_bytes"] += staged
            e["s"] += seconds

    def add_stage(self, op: str, stage: str, seconds: float) -> None:
        """Seconds of one stage of a staged collective (within its "s")."""
        with self._lock:
            e = self._entry(op)
            e[stage] = e.get(stage, 0.0) + seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {op: dict(e) for op, e in self.by_op.items()}


stats = CollectiveStats()


@contextmanager
def _counted(op: str, pg: "ProcessGroup", t: torch.Tensor, staged: int):
    """Time the block into `stats`: `t`'s payload, and `staged` host bytes
    (both ways) when the Gloo path stages a CUDA tensor through the host;
    then the device's queued work is waited for before the clock starts."""
    staging = _staged(pg, t)
    if staging:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    stats.add(op, t.numel() * t.element_size(), staged if staging else 0,
              time.perf_counter() - t0)


def initialize(coordinator: str, num_processes: int, process_id: int, backend: str | None = None,
               device=None, timeout_s: float = 300.0) -> ProcessGroup:
    """Join this process to the group, as `jax.distributed.initialize`.

    coordinator: JAX's "host:port" or a torch init_method ("tcp://...",
    "file://..."). device: this process's device (default: the card,
    RuntimeError without CUDA). backend: "nccl" or "gloo"; default "nccl"
    on the card and "gloo" on the CPU. timeout_s bounds every collective,
    so a lost peer raises."""
    global _current
    if _current is not None:
        raise RuntimeError("this process already joined a process group")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s), **kw)
    _current = ProcessGroup(dist.group.WORLD, process_id, num_processes, backend, dev, timeout_s)
    return _current


def current() -> ProcessGroup | None:
    """The group `initialize` opened in this process, or None."""
    return _current


def shutdown() -> None:
    """Leave the group (a no-op when none is open)."""
    global _current
    if _current is not None:
        dist.destroy_process_group()
        _current = None
        _subgroups.clear()


def subgroup(ranks) -> ProcessGroup | None:
    """The group over `ranks` (ranks of the open group, in order), created
    at the first call for that rank set and reused after; None on a
    process outside it. `torch.distributed.new_group` must be called by
    every process, members or not, in the same order, so every process
    calls this for every rank set in the same order (`make_mesh` does):
    one that skips a call leaves the others waiting until the timeout.
    A subgroup's collectives wait as long as the open group's."""
    pg = _current
    if pg is None:
        raise RuntimeError("subgroup() needs a process group: call initialize() first")
    key = tuple(int(r) for r in ranks)
    if key not in _subgroups:
        if key == tuple(range(pg.size)):
            _subgroups[key] = pg
        else:
            g = dist.new_group(list(key), timeout=timedelta(seconds=pg.timeout_s))
            _subgroups[key] = (ProcessGroup(g, key.index(pg.rank), len(key), pg.backend, pg.device,
                                            pg.timeout_s)
                               if pg.rank in key else None)
    return _subgroups[key]


def process_layout(data: int, shard: int, n_local: int, n_proc: int) -> str:
    """How a (data, shard) grid filled row-major by `n_proc` processes of
    `n_local` devices each (in rank order) falls on the processes:

    - "local": one process holds the whole grid;
    - "data": every process holds whole data rows (n_local a multiple of
      shard: the reference's MeshConfig(data=2, shard=4) over two hosts);
    - "shard": every data row splits into equal blocks of whole processes
      (shard a multiple of n_local), each holding a contiguous block of
      the row's shards: the reference's search mesh
      Mesh(jax.devices(), ("shard",)) at data 1, tensor parallelism
      across processes at any data.

    Any other split (a block that straddles data rows) raises ValueError."""
    if min(data, shard, n_local, n_proc) < 1:
        raise ValueError(f"sizes must be positive: data={data} shard={shard} "
                         f"n_local={n_local} n_proc={n_proc}")
    if data * shard != n_local * n_proc:
        raise ValueError(f"a {data}x{shard} mesh needs {data * shard} devices; {n_proc} "
                         f"processes of {n_local} give {n_local * n_proc}")
    if n_proc == 1:
        return "local"
    if n_local % shard == 0:
        return "data"
    if shard % n_local == 0:
        return "shard"
    raise ValueError(
        f"a {data}x{shard} mesh over {n_proc} processes of {n_local} devices splits data rows "
        "across processes unevenly; supported: whole data rows a process, or data rows split "
        "into equal blocks of shards a process")


def _staged(pg: ProcessGroup, t: torch.Tensor) -> bool:
    return pg.backend == "gloo" and t.device.type == "cuda"


def _check_transport(pg: ProcessGroup, t: torch.Tensor) -> None:
    """NCCL moves CUDA tensors only: refuse any other before it reaches
    the backend, whose own error does not name the tensor."""
    if pg.backend == "nccl" and t.device.type != "cuda":
        raise ValueError(f"an NCCL group takes CUDA tensors, got one on {t.device}: run the "
                         "collective on the tensor's device and move its result afterwards")


def _to_host(t: torch.Tensor, op: str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A fresh pinned host copy of CUDA tensor `t`, in `dtype`; its stages
    timed into `stats` under `op`."""
    t0 = time.perf_counter()
    h = torch.empty(t.shape, dtype=dtype or t.dtype, pin_memory=True)
    t1 = time.perf_counter()
    h.copy_(t.to(h.dtype))
    stats.add_stage(op, "pin_s", t1 - t0)
    stats.add_stage(op, "to_host_s", time.perf_counter() - t1)
    return h


def _to_device(h: torch.Tensor, like: torch.Tensor, op: str) -> torch.Tensor:
    """Host tensor `h` back on `like`'s device in its dtype (the copy up
    timed into `stats` under `op`)."""
    t0 = time.perf_counter()
    out = h.to(like.device).to(like.dtype)
    stats.add_stage(op, "to_device_s", time.perf_counter() - t0)
    return out


def all_gather(t: torch.Tensor, pg: ProcessGroup) -> list[torch.Tensor]:
    """Every process's `t` (same shape and dtype everywhere), in rank
    order, on `t`'s device. Through Gloo the bytes travel, so any dtype
    comes back bit for bit."""
    t = t.detach().contiguous()
    _check_transport(pg, t)
    with _counted("all_gather", pg, t, t.numel() * t.element_size() * (1 + pg.size)):
        if pg.backend == "nccl":
            out = [torch.empty_like(t) for _ in range(pg.size)]
            dist.all_gather(out, t, group=pg.group)
            return out
        raw, staged = t.reshape(-1).view(torch.uint8), _staged(pg, t)
        src = _to_host(raw, "all_gather") if staged else raw
        out = [torch.empty_like(src) for _ in range(pg.size)]
        dist.all_gather(out, src, group=pg.group)
        return [(_to_device(o, raw, "all_gather") if staged else o).view(t.dtype).reshape(t.shape)
                for o in out]


def all_reduce_sum(t: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
    """The sum of every process's `t`, a new tensor on `t`'s device in its
    dtype. bf16 and f16 are summed in f32 and cast back once, on either
    backend."""
    t = t.detach()
    _check_transport(pg, t)
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    with _counted("all_reduce", pg, t, 2 * t.numel() * wide.itemsize):
        if pg.backend == "nccl":
            out = t.to(wide, copy=True)
            dist.all_reduce(out, group=pg.group)
            return out.to(t.dtype)
        staged = _staged(pg, t)
        h = _to_host(t, "all_reduce", wide) if staged else t.to(wide, copy=True)
        dist.all_reduce(h, group=pg.group)
        return _to_device(h, t, "all_reduce") if staged else h.to(t.dtype)


def all_reduce_flat(tensors: list[torch.Tensor], pg: ProcessGroup) -> list[torch.Tensor]:
    """`all_reduce_sum` of each tensor, as one collective a (dtype, device)
    over their flattened concatenation (a model's gradients are hundreds
    of leaves)."""
    out: list = [None] * len(tensors)
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = all_reduce_sum(torch.cat([tensors[i].detach().reshape(-1) for i in idx]), pg)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def broadcast(t: torch.Tensor, src: int, pg: ProcessGroup) -> torch.Tensor:
    """Process `src`'s `t` on every process (a new tensor on `t`'s device;
    every process passes a tensor of the same shape and dtype)."""
    t = t.detach().contiguous()
    _check_transport(pg, t)
    with _counted("broadcast", pg, t, 2 * t.numel() * t.element_size()):
        if pg.backend == "nccl":
            out = t.clone()
            dist.broadcast(out, src, group=pg.group)
            return out
        raw, staged = t.reshape(-1).view(torch.uint8), _staged(pg, t)
        h = _to_host(raw, "broadcast") if staged else raw.clone()
        dist.broadcast(h, src, group=pg.group)
        return (_to_device(h, raw, "broadcast") if staged else h).view(t.dtype).reshape(t.shape)


def barrier(pg: ProcessGroup) -> None:
    """Wait until every process of the group arrives."""
    if pg.backend == "nccl":
        dist.barrier(group=pg.group, device_ids=[pg.device.index])
    else:
        dist.barrier(group=pg.group)


class GatherRows(torch.autograd.Function):
    """Forward: every process's rows (B_local, ...) concatenated in rank
    order. Backward: this process's slice of the upstream gradient, as it
    is. Every process takes the same loss of the gathered rows, so each
    upstream gradient is the whole one; a sum over processes would count
    it pg.size times."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
        ctx.lo, ctx.n = pg.rank * x.shape[0], x.shape[0]
        return torch.cat(all_gather(x, pg))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(0, ctx.lo, ctx.n), None


def gather_rows(x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
    """Differentiable gather of every process's rows in rank order (see
    `GatherRows`)."""
    return GatherRows.apply(x, pg)


class _RowBcast(torch.autograd.Function):
    """Forward: `x` as it is (every process of the row holds it whole).
    Backward: the gradient summed over the row, since each process's
    per-shard work read `x` for its own shards only."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_sum(g, ctx.pg), None


class _RowReduce(torch.autograd.Function):
    """Forward: the sum over the row of every process's partial. Backward:
    the gradient as it is: every process of the row carries the whole
    upstream gradient of the replicated sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
        return all_reduce_sum(x, pg)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _RowGather(torch.autograd.Function):
    """Forward: every process's block concatenated along `dim` in rank
    order. Backward: the gradient summed over the row, then this process's
    block (a reduce-scatter): every process runs the gathered work on all
    blocks and keeps its own output, so each block's gradient has a part
    from every process. (`GatherRows`'s slice with no sum is right only
    where every process takes the same loss of the gathered rows.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pg: ProcessGroup, dim: int) -> torch.Tensor:
        ctx.pg, ctx.dim = pg, dim
        ctx.lo, ctx.n = pg.rank * x.shape[dim], x.shape[dim]
        return torch.cat(all_gather(x, pg), dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_sum(g, ctx.pg).narrow(ctx.dim, ctx.lo, ctx.n), None, None


def row_bcast(x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
    """A replicated tensor read by per-shard work on a row split over the
    processes of `pg`: identity forward, gradient summed over the row."""
    return _RowBcast.apply(x, pg)


def row_reduce(x: torch.Tensor, pg: ProcessGroup) -> torch.Tensor:
    """The sum of every row process's partial `x`, identity backward."""
    return _RowReduce.apply(x, pg)


def row_gather(x: torch.Tensor, pg: ProcessGroup, dim: int = -1) -> torch.Tensor:
    """Every row process's block of a tensor concatenated along `dim`;
    the backward a reduce-scatter (`_RowGather`)."""
    return _RowGather.apply(x, pg, dim % x.ndim)
