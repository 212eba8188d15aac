"""One PROCESS of a multi-process run of the port: the twin of
tests/multihost_worker.py (the reference's worker for
tests/test_multihost.py), spawned by tests/test_torch_multihost.py on the
CPU and by chip_smoke.py's multiproc phases on the card.

    python tests/torch_multihost_worker.py --rank R --world W \\
        --init file:///path/to/rendezvous --device cpu --out r.json

Each process joins the group (`core/distributed.py:initialize`: Gloo on
the CPU, NCCL or Gloo on the card as `--backend` says), passes its
`--local` devices to `make_mesh`, runs the parts that `--parts` names and
writes one JSON object with a key a part:

- search: the reference worker's corpus (`default_rng(0)`, n x d unit
  rows, queries rows[:B] + 0.01 noise; on the card the rows are drawn on
  the device from a seeded torch generator) in a global-scale int8
  FlatIndex row-sharded over the (1, world * local) mesh: the speed path
  with a rescore copy, its ids and scores;
- routes: the masked, grouped, exact (per-row int8, kernel B5) and
  residual routes over the same mesh, and the list-sharded IVF searcher
  (rank 0 builds the IVF index, broadcasts it and saves it under
  `--workdir` for the test);
- ivf: the list-sharded IVF searcher on a clustered corpus (the card's
  run; on the CPU the routes part covers the IVF route);
- live: adds, an update and deletes, then compact(reclaim=True);
- train: the dp + tp train step on a (data, shard) mesh whose data rows
  are split over the processes: losses, the gradient norm each update
  read, how far the params moved, a checksum of the params, and a check
  that the sum over processes of a bf16 tensor of the gradients' size is
  the f32 sum of the gathered tensors cast back, bit for bit (and, with
  `--lora-steps`, LoRA steps over the frozen sharded base).
  `--train-control` breaks the gradient sum on purpose (`train_control`)
  to show what the readings against one process catch;
- encode: a dp encode over a (world * local, 1) mesh;
- tp: tensor parallelism on a `--tp-mesh` (data, shard) mesh whose data
  rows may span processes, for each tower `--tp-towers` names (params
  from `--tp-params-dir`, else drawn from a seeded generator): the tp
  encode (`BatchedEncoder` on the tower's `shard_params`), the dp + tp
  train step and LoRA steps (`--train-*`, `--lora-steps`), with
  `--tp-checkpoint` a save_checkpoint that process 0 restores on one
  device, and with `--tp-controls` the train step again with a row
  collective broken on purpose (`tp_control`).

Every process builds the same index, as the reference's worker does, and
applies the same mutation stream. Each part also reports the kernel
launches of its window and the collectives' stats. The parts that
`--check-one-process` names run again on a one-process mesh of as many
entries, outside the window, and report whether the results are
bit-equal (train: on process 0 alone, whose params the others hold bit
for bit, with the distances of `train_readings`). The module's functions
are what the test runs on its one-process mesh, so both sides run the
same code. `launch` and `run_workers` start a group of processes and
wait for them under one deadline (tests/torch_helpers.py and
chip_smoke.py call them). Nothing here imports jax or the reference
package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARTS = ("search", "routes", "ivf", "live", "train", "encode", "tp")
CONTROLS = ("sum", "no_sum", "doubled_sum")
TP_CONTROLS = ("gather_slice", "bcast_no_sum", "row_sum")
COLLECTIVE_TIMEOUT_S = 180.0
# a leaf's first gradient norm at or below this share of the global one is
# 0 to rounding (tp_readings)
ZERO_GRAD_REL = 1e-5
TRAIN_TEXTS = ([f"query topic {i}" for i in range(8)], [f"statement topic {i}" for i in range(8)])
ENCODE_TEXTS = [f"multi host encode check {i}" for i in range(8)]


# ---------------------------------------------------------------- inputs


def corpus(n: int, d: int, batch: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(rows (n, d) f32 unit, queries (batch, d) f32). On the CPU the
    reference worker's draws; on the card rows from a torch generator
    seeded 7 (chip_smoke's phase-6 corpus) and unit queries seeded 1000,
    drawn on the device in 131,072-row chunks."""
    dev = torch.device(device)
    if dev.type != "cuda":
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((n, d), dtype=np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        return vecs, vecs[:batch] + 0.01 * rng.standard_normal((batch, d), dtype=np.float32)
    vecs = np.empty((n, d), np.float32)
    g = torch.Generator(device=dev).manual_seed(7)
    for i in range(0, n, 131_072):
        x = torch.randn((min(131_072, n - i), d), generator=g, device=dev)
        vecs[i : i + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    return vecs, unit_rows(batch, d, 1000, dev).cpu().numpy()


def unit_rows(n: int, d: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def meta_rows(n: int) -> list[dict]:
    """Metadata rows for the filtered routes: years, categories and both
    sources spread over the rows."""
    return [{"paper_id": f"{2000 + i % 26}.{i:05d}", "paper_title": f"Paper {i % 50}",
             "authors": [f"Author {i % 100}"],
             "link": (f"https://arxiv.org/abs/{i}" if i % 5
                      else f"https://stacks.math.columbia.edu/tag/{i}"),
             "year": 2000 + i % 25, "primary_category": f"math.{['AG', 'NT', 'CO', 'PR'][i % 4]}",
             "journal_ref": None, "citations": i % 500, "theorem_name": "Theorem 1.",
             "theorem_body": f"body {i}", "slogan": f"slogan {i}"} for i in range(n)]


def grouped_filters(n: int) -> list:
    """A heterogeneous batch's filters: none, year ranges, a source, a tag."""
    from theoremsearch_tpu_torch.search.filters import SearchFilters

    out = []
    for i in range(n):
        if i % 4 == 0:
            out.append(None)
        elif i % 4 == 1:
            lo = 2000 + (i % 5) * 4
            out.append(SearchFilters(year_range=(lo, lo + 4)))
        elif i % 4 == 2:
            out.append(SearchFilters(sources=["Stacks Project"]))
        else:
            out.append(SearchFilters(tags=[f"math.{['AG', 'NT'][i % 2]}"]))
    return out


def live_stream(n: int, d: int, adds: int, deletes: int):
    """The reference worker's mutation stream, scaled: `adds` new unit rows
    and one more for update_document(17, ...) from default_rng(1); deletes
    of doc 9 and of the first new id when `deletes` is 2, else of
    `deletes - deletes // 11` main ids (9 first) and `deletes // 11` new
    ids. Returns (new rows, main ids to delete, how many new ids to delete)."""
    rng = np.random.default_rng(1)
    new = rng.standard_normal((adds + 1, d), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    n_new = max(1, deletes // 11)
    main = [9] + [int(x) for x in range(n // 2, n // 2 + deletes - n_new - 1)]
    return new, main, n_new


# ---------------------------------------------------------------- parts


def flat_index(vecs: np.ndarray, device, per_row: bool = False):
    """A global-scale int8 FlatIndex (the speed path's), or a per-row int8
    one (the exact route's, kernel B5)."""
    from theoremsearch_tpu_torch.core.config import IndexConfig
    from theoremsearch_tpu_torch.index.flat import FlatIndex

    cfg = IndexConfig(dtype="int8") if per_row else IndexConfig(dtype="int8", int8_scale="global")
    return FlatIndex.build(vecs, ids=np.arange(vecs.shape[0]), config=cfg, device=device)


def flat_engine(vecs: np.ndarray, mesh, device, args, *, meta=None, per_row=False,
                residual=False, idx=None):
    """The engine the parts search over `idx` (default: `flat_index`'s):
    the global-scale int8 speed path with a rescore copy (or the residual
    codes), or the exact route over a per-row int8 index."""
    from theoremsearch_tpu_torch.index.quant import quantize_residual_int8
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

    n = vecs.shape[0]
    idx = idx if idx is not None else flat_index(vecs, device, per_row)
    kw = {}
    if residual:
        kw["rescore_residual"] = quantize_residual_int8(torch.from_numpy(vecs), idx.vectors[:n],
                                                        idx.global_scale)
    elif not per_row:
        kw["rescore_vectors"] = vecs
    return SearchEngine(idx, meta=None if meta is None else CorpusMetadata.from_rows(meta),
                        mesh=mesh, row_block=args.row_block or None,
                        rescore_factor=args.rescore_factor,
                        **kw)


def search_lists(eng, queries, k: int, filters=None) -> dict:
    s, i = eng.search_vectors(queries, k=k, filters=filters)
    return {"ids": np.asarray(i).tolist(), "scores": np.asarray(s, np.float64).tolist()}


IVF_ARRAYS = ("centroids", "slabs", "slab_scales", "slab_ids", "spill", "spill_scales",
              "spill_ids", "raw_flat", "res_flat", "res_scales_flat")


def ivf_index(vecs: np.ndarray, device, args, pg, save_dir: str | None = None,
              times: dict | None = None):
    """The IVF index every process searches: built once (by rank 0 when a
    group is given: k-means on the card need not repeat bit for bit) and
    broadcast over the group, array by array; saved under `save_dir` too
    when one is given. `times` gets the seconds of each stage."""
    from theoremsearch_tpu_torch.core import distributed
    from theoremsearch_tpu_torch.core.config import IndexConfig
    from theoremsearch_tpu_torch.index.ivf import IVFIndex

    times = {} if times is None else times
    t0 = time.perf_counter()
    ivf = None
    if pg is None or pg.rank == 0:
        ivf = IVFIndex.build(vecs, config=IndexConfig(ivf_nlist=args.ivf_nlist, dtype="int8"),
                             normalize=False, device=device)
        times["build_s"] = time.perf_counter() - t0
        if save_dir:
            ivf.save(os.path.join(save_dir, "ivf"))
    if pg is None:
        return ivf
    t0 = time.perf_counter()
    head = b""
    if pg.rank == 0:
        head = json.dumps({
            "num_rows": ivf.num_rows, "config": ivf.config.to_dict(),
            "global_scale": ivf.global_scale,
            "arrays": {k: [list(getattr(ivf, k).shape), str(getattr(ivf, k).dtype)]
                       for k in IVF_ARRAYS if getattr(ivf, k) is not None}}).encode()
    n = int(distributed.broadcast(torch.tensor([len(head)]), 0, pg))
    buf = torch.frombuffer(bytearray(head), dtype=torch.uint8) if head else torch.zeros(n, dtype=torch.uint8)
    meta = json.loads(bytes(distributed.broadcast(buf, 0, pg).numpy()).decode())
    arrays = {}
    for k, (shape, dtype) in meta["arrays"].items():
        t = getattr(ivf, k) if ivf is not None else torch.empty(shape, dtype=getattr(torch, dtype[6:]))
        arrays[k] = distributed.broadcast(t, 0, pg)
    times["broadcast_s"] = time.perf_counter() - t0
    return IVFIndex(**arrays, num_rows=meta["num_rows"], config=IndexConfig.from_dict(meta["config"]),
                    global_scale=meta["global_scale"], device=device)


def ivf_corpus(n: int, d: int, nlist: int, device) -> np.ndarray:
    """Clustered unit rows (the reference's "overlap" geometry: a centre +
    1.5 / sqrt(d) gaussian noise, renormalized), made on `device` from a
    torch generator seeded 11."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(11)
    cents = torch.randn((nlist, d), generator=g, device=dev)
    cents /= cents.norm(dim=1, keepdim=True)
    out = np.empty((n, d), np.float32)
    for i in range(0, n, 65_536):
        m = min(65_536, n - i)
        pick = torch.randint(0, nlist, (m,), generator=g, device=dev)
        x = cents[pick] + (1.5 / d ** 0.5) * torch.randn((m, d), generator=g, device=dev)
        out[i : i + m] = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    return out


def train_batches(steps: int, vocab_size: int, path: str | None = None) -> list[tuple]:
    """(q ids, q mask, p ids, p mask) a step: the npz at `path` (q and p
    token arrays of shape (steps, B, S), full masks) or the reference
    worker's tokenized pairs, the same batch every step."""
    if path:
        z = np.load(path)
        q, p = z["q"], z["p"]
        mask = np.ones(q.shape[1:], np.int32)
        return [(q[i], mask, p[i], mask) for i in range(steps)]
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(vocab_size=vocab_size)
    qe = tok(TRAIN_TEXTS[0], pad_to=16)
    pe = tok(TRAIN_TEXTS[1], pad_to=16)
    batch = (np.asarray(qe.input_ids), np.asarray(qe.attention_mask),
             np.asarray(pe.input_ids), np.asarray(pe.attention_mask))
    return [batch] * steps


def encoder_config(name: str):
    """"tiny": EncoderConfig.tiny(); "tiny_f32", "gemma_tiny_f32",
    "bert_tiny_f32": the three towers' tiny configs in f32 (the train
    twins' precision; gemma's at 2 layers, one sliding and one global);
    "qwen": the full-width Qwen3-0.6B-class tower at
    max_seq_len 64 with the padded vocabulary 151,936 (chip_smoke's
    mesh_train); "qwen4": the same at 4 layers; "qwen512": the full-width
    serving tower (EncoderConfig()); "gemma": the full-width
    embeddinggemma-300m-class tower at max_seq_len 128 (chip_smoke's
    mesh_encode_tp)."""
    from theoremsearch_tpu_torch.core.config import (
        BertEncoderConfig, EncoderConfig, GemmaEncoderConfig,
    )

    f32 = {"dtype": "float32", "param_dtype": "float32"}
    configs = {
        "tiny": EncoderConfig.tiny,
        "tiny_f32": lambda: EncoderConfig.tiny().replace(**f32),
        "gemma_tiny_f32": lambda: GemmaEncoderConfig.tiny().replace(num_layers=2, **f32),
        "bert_tiny_f32": lambda: BertEncoderConfig.tiny().replace(**f32),
        "qwen": lambda: EncoderConfig(vocab_size=151_936, max_seq_len=64),
        "qwen4": lambda: EncoderConfig(vocab_size=151_936, max_seq_len=64, num_layers=4),
        "qwen512": EncoderConfig,
        "gemma": lambda: GemmaEncoderConfig(max_seq_len=128),
    }
    if name not in configs:
        raise ValueError(f"unknown config {name!r}")
    return configs[name]()


def train_run(cfg, tcfg, mesh, batches, seed: int, fused: str, device,
              keep_params: bool = False, full=None, keep_state: bool = False) -> dict:
    """`len(batches)` dp + tp steps from `init_sharded_train_state` (params
    drawn from a generator seeded `seed` on the mesh's first device), or
    from the full params `full` placed by `shard_train_state` with zero
    moments: losses, step seconds, collective stats a step, the global
    gradient norm each update read (after the sum over processes, before
    the clip), the distance the params moved, a checksum of the logical
    params (gathered over the row where it spans processes, so every
    process holds the same bytes) and their element count (and, with
    keep_params, the logical params and the norm of each logical leaf's
    first gradient, from this process's pieces; with keep_state, the
    state)."""
    from theoremsearch_tpu_torch.core import distributed
    from theoremsearch_tpu_torch.encoder.sharding import ShardedTensor
    from theoremsearch_tpu_torch.train.contrastive import (
        TrainState, init_sharded_train_state, make_optimizer, make_train_step, shard_train_state,
        tree_leaves,
    )

    first = mesh.first_device
    if full is None:
        state = init_sharded_train_state(cfg, tcfg, mesh,
                                         generator=torch.Generator(device=first).manual_seed(seed))
    else:
        state = shard_train_state(TrainState(full, make_optimizer(tcfg).init(full), 0), mesh, cfg)
    start = logical_leaves(state.params)
    step = make_train_step(cfg, tcfg, mesh=mesh, fused=fused)
    losses, step_s, coll, norms, first_sq = [], [], [], [], []
    with grad_norms(norms, first_sq if keep_params else None):
        for b in batches:
            sync(first)
            distributed.stats.reset()
            t0 = time.perf_counter()
            state, loss = step(state, *b)
            losses.append(float(loss))
            sync(first)
            step_s.append(time.perf_counter() - t0)
            coll.append(distributed.stats.snapshot())
    end = logical_leaves(state.params)
    res = {"losses": losses, "step_s": step_s, "collectives_a_step": coll,
           "grad_norms": [float(n) for n in norms], "update_norm": distance(end, start),
           "params_sha256": digest(end), "numel": sum(t.numel() for t in end)}
    if keep_params:
        res["params"] = end
        sq = iter(first_sq)
        res["leaf_grad_norms"] = [
            sum(next(sq) for _ in (x.pieces if isinstance(x, ShardedTensor) else [x])) ** 0.5
            for x in tree_leaves(state.params)]
    if keep_state:
        res["state"] = state
    return res


def lora_run(cfg, tcfg, mesh, batches, seed: int, fused: str, full=None, lora=None) -> dict:
    """`len(batches)` LoRA steps (rank 4 on wq and wv) over frozen sharded
    base params drawn as `train_run` draws them (or `full` placed by the
    tower's `shard_params`), from adapters drawn from a generator seeded
    `seed + 1` (or `lora`): losses and a checksum of the adapters."""
    from theoremsearch_tpu_torch.encoder.families import family_module
    from theoremsearch_tpu_torch.train.contrastive import (
        TrainState, init_lora_train_state, init_sharded_train_state, make_lora_train_step,
        make_optimizer, piece_leaves,
    )

    first = mesh.first_device
    lcfg = tcfg.replace(lora_rank=4)
    if full is None:
        base = init_sharded_train_state(cfg, tcfg, mesh,
                                        generator=torch.Generator(device=first).manual_seed(seed)).params
    else:
        base = family_module(cfg).shard_params(full, mesh)
    if lora is None:
        state = init_lora_train_state(base, lcfg,
                                      generator=torch.Generator(device=first).manual_seed(seed + 1))
    else:
        lora = [{t: {k: v.to(first, copy=True) for k, v in ab.items()} for t, ab in e.items()}
                for e in lora]
        state = TrainState(lora, make_optimizer(lcfg).init(lora), 0)
    step = make_lora_train_step(cfg, lcfg, mesh=mesh, fused=fused)
    losses = []
    for b in batches:
        state, loss = step(state, base, *b)
        losses.append(float(loss))
    return {"losses": losses, "adapters_sha256": digest(piece_leaves(state.params))}


def encode_run(params, cfg, mesh, texts, quant: str, batch_size: int, buckets, device) -> np.ndarray:
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    enc = BatchedEncoder(params, cfg, mesh=mesh, batch_size=batch_size, buckets=buckets,
                         quant=quant, device=None if mesh is not None else device)
    return enc.encode(texts)


# ---------------------------------------------------------------- helpers


def local_mesh(data: int, shard: int, dev):
    """A (data, shard) mesh of `dev` repeated, in this process alone
    (whether or not it joined a group): the one-process reference."""
    from theoremsearch_tpu_torch.core.meshes import Mesh

    return Mesh(np.full((data, shard), torch.device(dev), dtype=object))


def logical_leaves(tree) -> list:
    """The logical leaves of a params tree (a sharded leaf's pieces joined,
    over the row group where the row spans processes: a collective every
    process of the row joins)."""
    from theoremsearch_tpu_torch.encoder.sharding import unshard_params
    from theoremsearch_tpu_torch.train.contrastive import tree_leaves

    return [t.detach() for t in tree_leaves(unshard_params(tree))]


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def distance(a: list, b: list) -> float:
    """The f32 distance between two lists of tensors of matching shapes."""
    return float(sum(float(((x.float() - y.float()) ** 2).sum()) for x, y in zip(a, b))) ** 0.5


@contextmanager
def grad_norms(out: list, first_pieces: list | None = None):
    """Append to `out` the global gradient norm every AdamW update reads
    (after the sum over processes, before the clip), and to `first_pieces`
    (when given) the sum of squares of each piece's gradient at the first
    update, in `piece_leaves` order."""
    from theoremsearch_tpu_torch.train.contrastive import AdamW

    orig = AdamW.global_norm

    def recorded(self, grads, row=None):
        n = orig(self, grads, row)
        if first_pieces is not None and not out:
            first_pieces.extend(float(torch.linalg.vector_norm(g, dtype=torch.float32)) ** 2
                                for g in grads)
        out.append(n)
        return n

    AdamW.global_norm = recorded
    try:
        yield out
    finally:
        AdamW.global_norm = orig


@contextmanager
def train_control(name: str):
    """The train step's gradient sum over processes as the port takes it
    ("sum"), or broken for a control run: "no_sum" (each process keeps its
    own gradient), "doubled_sum" (twice the sum)."""
    from theoremsearch_tpu_torch.train import contrastive

    orig = contrastive.all_reduce_flat
    if name == "no_sum":
        contrastive.all_reduce_flat = lambda grads, pg: grads
    elif name == "doubled_sum":
        contrastive.all_reduce_flat = lambda grads, pg: [2 * g for g in orig(grads, pg)]
    elif name != "sum":
        raise ValueError(f"unknown train control {name!r}")
    try:
        yield
    finally:
        contrastive.all_reduce_flat = orig


class _SliceGather(torch.autograd.Function):
    """`distributed.row_gather` with `GatherRows`'s backward: the own block
    of the gradient, not summed over the row."""

    @staticmethod
    def forward(ctx, x, pg, dim):
        from theoremsearch_tpu_torch.core import distributed

        ctx.dim, ctx.lo, ctx.n = dim, pg.rank * x.shape[dim], x.shape[dim]
        return torch.cat(distributed.all_gather(x, pg), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


@contextmanager
def tp_control(name: str):
    """A tensor-parallel collective broken on purpose, for a control run:
    "gather_slice" (the gathered core's backward a plain slice),
    "bcast_no_sum" (a replicated input's gradient not summed over the row)
    or "row_sum" (a replicated leaf's gradient also summed over the row,
    before the update)."""
    from theoremsearch_tpu_torch.core import distributed
    from theoremsearch_tpu_torch.encoder import sharding
    from theoremsearch_tpu_torch.train import contrastive

    saved = [(sharding, "row_gather", sharding.row_gather),
             (sharding, "row_bcast", sharding.row_bcast),
             (contrastive.AdamW, "update", contrastive.AdamW.update)]
    if name == "gather_slice":
        sharding.row_gather = lambda x, pg, dim=-1: _SliceGather.apply(x, pg, dim % x.ndim)
    elif name == "bcast_no_sum":
        sharding.row_bcast = lambda x, pg: x
    elif name == "row_sum":
        update = contrastive.AdamW.update

        def summed(self, grads, state, params, row=None):
            group, order = row
            pieces = {pos for r, pos in order if r > 0}
            grads = [g if i in pieces else distributed.all_reduce_sum(g, group)
                     for i, g in enumerate(grads)]
            return update(self, grads, state, params, row)

        contrastive.AdamW.update = summed
    else:
        raise ValueError(f"unknown tp control {name!r}")
    try:
        yield
    finally:
        for obj, attr, val in saved:
            setattr(obj, attr, val)


def train_readings(run: dict, one: dict, param_distance: float) -> dict:
    """How far a run across processes is from the one-process mesh's run
    on the same batches: whether the first losses are equal, the largest
    loss difference, the relative difference of the first gradient norms
    (the first sum over processes, before the trajectories part) and the
    largest over the steps, the distance between the final params over
    the distance the one-process params moved, and (where both runs kept
    them) the largest relative difference of one piece's first gradient
    norm (a broken sum of a few small leaves moves the global norm
    little, and AdamW does not see a leaf's gradient scale)."""
    rel = [abs(a / b - 1.0) for a, b in zip(run["grad_norms"], one["grad_norms"])]
    return {"first_loss_equal": run["losses"][0] == one["losses"][0],
            "max_loss_delta": max(abs(a - b) for a, b in zip(run["losses"], one["losses"])),
            "first_grad_norm_rel": rel[0], "max_grad_norm_rel": max(rel),
            "param_distance_rel": param_distance / one["update_norm"]}


def staged_sum_check(pg, dev, numel: int) -> dict:
    """`distributed.all_reduce_sum` of a bf16 tensor of `numel` elements
    (drawn per rank) against the f32 sum, in rank order, of the tensors
    `all_gather` brings back, cast to bf16: whether the two are bit-equal,
    and the bytes the sum staged through the host."""
    from theoremsearch_tpu_torch.core import distributed

    g = torch.Generator(device=dev).manual_seed(100 + pg.rank)
    x = torch.randn(numel, generator=g, device=dev).to(torch.bfloat16)
    distributed.stats.reset()
    got = distributed.all_reduce_sum(x, pg)
    staged = distributed.stats.snapshot()["all_reduce"]["staged_bytes"]
    parts = distributed.all_gather(x, pg)
    want = parts[0].float()
    for p in parts[1:]:
        want += p.float()
    return {"numel": numel, "bit_equal": bool(torch.equal(got.view(torch.int16),
                                                          want.to(torch.bfloat16).view(torch.int16))),
            "staged_bytes": staged}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def counters() -> dict:
    from theoremsearch_tpu_torch.kernels import attention, layer_int8, mips

    return {"mips_g_scan": mips.mips_g_launches, "mips_g_scan_mask": mips.mips_g_mask_launches,
            "mips_g_scan_gmask": mips.mips_g_gmask_launches, "mips_topk": mips.mips_topk_launches,
            "ivf_probe_scores": mips.ivf_scores_launches,
            "qknorm_rope_attention": attention.attention_launches,
            "qknorm_rope_attention_gemma": attention.attention_gemma_launches,
            "qknorm_rope_attention_bwd": attention.attention_bwd_launches,
            "fused_attn_int8_layer": layer_int8.attn_int8_launches,
            "fused_mlp_int8_layer": layer_int8.mlp_int8_launches}


class Window:
    """Kernel launches and collective stats from entry to exit."""

    def __enter__(self):
        from theoremsearch_tpu_torch.core import distributed

        self.c = counters()
        self.start = {k: c.n for k, c in self.c.items()}
        distributed.stats.reset()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from theoremsearch_tpu_torch.core import distributed

        self.seconds = time.perf_counter() - self.t0
        self.launches = {k: c.n - self.start[k] for k, c in self.c.items()}
        self.collectives = distributed.stats.snapshot()
        return False

    def report(self) -> dict:
        return {"launches": self.launches, "collectives": self.collectives, "s": self.seconds}


def log(rank: int, msg: str) -> None:
    print(f"[worker {rank}] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the run


def search_mesh(a, local):
    """The mesh the search part runs on: `--search-mesh` (data, shard), or
    every entry on the shard axis (1, world * local)."""
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    if not a.search_mesh:
        return make_mesh(None, devices=local)
    data, shard = (int(x) for x in a.search_mesh.split(","))
    return make_mesh(MeshConfig(data=data, shard=shard), devices=local)


def part_search(a, dev, local, pg, out) -> None:
    vecs, queries = corpus(a.n, a.d, a.batch, dev)
    mesh = search_mesh(a, local)
    idx = flat_index(vecs, dev)
    eng = flat_engine(vecs, mesh, dev, a, idx=idx)
    with Window() as w:
        got = search_lists(eng, queries, a.k)
    res = {"n_global_shards": mesh.shape["shard"], "layout": mesh.layout,
           "local_shards": [s for s, _ in mesh.local_shards], "local_rows": mesh.local_rows,
           "sharded_speed_ok": eng._speed_ok, **got, **w.report()}
    if a.time_iters:
        t0 = time.perf_counter()
        for _ in range(a.time_iters):
            eng.search_vectors(queries, k=a.k)
        res["batch_ms"] = (time.perf_counter() - t0) / a.time_iters * 1e3
    if a.recall_draws:
        from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
        from theoremsearch_tpu_torch.eval.oracle import exact_topk

        qd = [unit_rows(1024, a.d, 5000 + s, dev) for s in range(a.recall_draws)]
        corpus_dev = torch.from_numpy(vecs).to(dev)
        _, oracle = exact_topk(torch.cat(qd), corpus_dev, k=10, device=dev)
        del corpus_dev
        res["recall"] = [recall_vs_exact(np.asarray(eng.search_vectors(q, k=10)[1]),
                                         oracle[s * 1024 : (s + 1) * 1024], k=10)
                         for s, q in enumerate(qd)]
    if a.trace_dir:
        from theoremsearch_tpu_torch.utils.profiling import trace

        with trace(a.trace_dir, device=dev) as prof:
            eng.search_vectors(queries, k=a.k)
        with open(prof.trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        res["trace"] = {"path": prof.trace_path,
                        "kernels": sorted(n for n in names if "mips_g" in n)}
    one_mesh = local_mesh(mesh.shape["data"], mesh.shape["shard"], dev)
    if "search" in a.check_one_process:
        res["equal_one_process"] = search_lists(flat_engine(vecs, one_mesh, dev, a, idx=idx),
                                                queries, a.k) == got
    del eng, idx
    if a.exact_batch:
        pidx = flat_index(vecs, dev, per_row=True)
        peng = flat_engine(vecs, mesh, dev, a, idx=pidx)
        with Window() as w:
            ex = search_lists(peng, queries[: a.exact_batch], a.k)
        res["exact"] = {**ex, **w.report()}
        if "search" in a.check_one_process:
            del peng
            pone = flat_engine(vecs, one_mesh, dev, a, idx=pidx)
            res["exact"]["equal_one_process"] = search_lists(
                pone, queries[: a.exact_batch], a.k) == ex
    out["search"] = res


def part_routes(a, dev, local, pg, out) -> None:
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    vecs, queries = corpus(a.n, a.d, a.batch, dev)
    mesh = make_mesh(None, devices=local)
    ivf = ivf_index(vecs, dev, a, pg, save_dir=a.workdir)
    with Window() as w:
        res = route_results(vecs, queries, mesh, dev, a, ivf)
    res.update(w.report())
    out["routes"] = res


def route_results(vecs, queries, mesh, dev, a, ivf) -> dict:
    """The masked, grouped, exact, residual and IVF routes' (ids, scores)
    and the routes each engine counted."""
    from theoremsearch_tpu_torch.search.filters import SearchFilters

    res = {}
    meta = meta_rows(vecs.shape[0])
    idx = flat_index(vecs, dev)
    eng = flat_engine(vecs, mesh, dev, a, meta=meta, idx=idx)
    res["masked"] = search_lists(eng, queries, a.k,
                                 SearchFilters(sources=["arXiv"], year_range=(2010, 2016)))
    res["grouped"] = search_lists(eng, queries, a.k, grouped_filters(len(queries)))
    res["route_counts"] = dict(eng.route_counts)
    res["exact"] = search_lists(flat_engine(vecs, mesh, dev, a, per_row=True), queries, a.k)
    res["residual"] = search_lists(flat_engine(vecs, mesh, dev, a, residual=True, idx=idx),
                                   queries, a.k)
    s, i = ivf.sharded_searcher(mesh, k=a.k, nprobe=a.ivf_nprobe)(
        torch.from_numpy(np.ascontiguousarray(queries)))
    res["ivf"] = {"ids": i.cpu().numpy().tolist(), "scores": s.cpu().double().numpy().tolist()}
    return res


def part_ivf(a, dev, local, pg, out) -> None:
    """The list-sharded IVF searcher (kernel B6) over the (1, world * local)
    mesh on a clustered corpus of `--ivf-rows` rows, B = `--ivf-batch`
    queries (rows plus 0.01 noise)."""
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    t0 = time.perf_counter()
    vecs = ivf_corpus(a.ivf_rows, a.d, a.ivf_nlist, dev)
    corpus_s = time.perf_counter() - t0
    noise = unit_rows(a.ivf_batch, a.d, 13, dev).cpu().numpy()
    q = vecs[: a.ivf_batch] + 0.01 * noise
    queries = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))
    times = {"corpus_s": corpus_s}
    ivf = ivf_index(vecs, dev, a, pg, times=times)
    res = {"rows": a.ivf_rows, "nlist": a.ivf_nlist, "nprobe": a.ivf_nprobe,
           "slab_rows": int(ivf.slabs.shape[1]), "times": times}
    del vecs
    mesh = make_mesh(None, devices=local)
    t0 = time.perf_counter()
    search = ivf.sharded_searcher(mesh, k=a.k, nprobe=a.ivf_nprobe)
    search(queries)
    times["place_and_first_search_s"] = time.perf_counter() - t0
    with Window() as w:
        s, i = search(queries)
        got = {"ids": i.cpu().numpy().tolist(), "scores": s.cpu().double().numpy().tolist()}
    res.update(got)
    res.update(w.report())
    if "ivf" in a.check_one_process:
        n = mesh.shape["shard"]
        one_mesh = local_mesh(1, n, dev)
        t0 = time.perf_counter()
        s1, i1 = ivf.sharded_searcher(one_mesh, k=a.k, nprobe=a.ivf_nprobe)(queries)
        res["equal_one_process"] = bool(torch.equal(s1, s) and torch.equal(i1, i))
        times["one_process_check_s"] = time.perf_counter() - t0
    out["ivf"] = res


def part_live(a, dev, local, pg, out) -> None:
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    vecs, queries = corpus(a.n, a.d, a.batch, dev)
    mesh = make_mesh(None, devices=local)
    eng = flat_engine(vecs, mesh, dev, a)
    with Window() as w:
        res = live_run(eng, vecs.shape[0], a.d, queries, a)
    res.update(w.report())
    out["live"] = res


def live_run(eng, n: int, d: int, queries, a) -> dict:
    """The mutation stream, then searches before and after compact(reclaim)."""
    new, main_del, n_new_del = live_stream(n, d, a.live_adds, a.live_deletes)
    ids_new = eng.add_documents(new[: a.live_adds], normalize=False)
    eng.update_document(17, new[a.live_adds])
    dels = main_del + [int(x) for x in ids_new[:n_new_del]]
    deleted = eng.delete_documents(dels)
    s_live, i_live = eng.search_vectors(queries, k=a.k)
    folded = eng.compact(reclaim=True)
    s_post, i_post = eng.search_vectors(queries, k=a.k)
    return {"deleted": int(deleted), "n_deletes": len(dels),
            "deleted_returned": bool(np.isin(np.asarray(i_live), dels).any()),
            "live_ids": np.asarray(i_live).tolist(),
            "live_scores": np.asarray(s_live, np.float64).tolist(),
            "post_reclaim_ids": np.asarray(i_post).tolist(),
            "post_reclaim_scores": np.asarray(s_post, np.float64).tolist(),
            "folded": int(folded), "num_live": int(eng.num_live)}


def part_train(a, dev, local, pg, out) -> None:
    from theoremsearch_tpu_torch.core.config import MeshConfig, TrainConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    cfg = encoder_config(a.train_config)
    data, shard = (int(x) for x in a.train_mesh.split(","))
    batches = train_batches(a.train_steps, cfg.vocab_size, a.train_batch)
    tcfg = TrainConfig(batch_size=int(batches[0][0].shape[0]), seq_len=int(batches[0][0].shape[1]),
                       learning_rate=a.lr, temperature=a.temperature)
    mesh = make_mesh(MeshConfig(data=data, shard=shard), devices=local)
    check = "train" in a.check_one_process and pg.rank == 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Window() as w, train_control(a.train_control):
        res = train_run(cfg, tcfg, mesh, batches, a.train_seed, a.fused, dev, keep_params=check)
    res.update(w.report())
    res["layout"] = mesh.layout
    res["local_rows"] = mesh.local_rows
    res["control"] = a.train_control
    if dev.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if pg.size > 1:
        res["staged_sum"] = staged_sum_check(pg, dev, res["numel"])
    if a.lora_steps:
        res["lora"] = lora_run(cfg, tcfg, mesh, batches[: a.lora_steps], a.train_seed, a.fused)
    if check:
        mine = res.pop("params")
        one = train_run(cfg, tcfg, local_mesh(data, shard, dev), batches, a.train_seed, a.fused,
                        dev, keep_params=True)
        res["one_process"] = {k: one[k] for k in ("losses", "grad_norms", "update_norm")}
        res["vs_one_process"] = train_readings(res, one, distance(mine, one.pop("params")))
        res["equal_one_process"] = (one["losses"] == res["losses"]
                                    and one["params_sha256"] == res["params_sha256"])
    if dev.type == "cuda":
        res["peak_mem_gb_part"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["train"] = res


def part_encode(a, dev, local, pg, out) -> None:
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder.model import init_params

    cfg = encoder_config(a.encode_config)
    if a.encode_params:
        params = torch.load(a.encode_params, map_location=dev, weights_only=True)
    else:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(a.encode_seed),
                             device=dev)
    texts = ENCODE_TEXTS
    if a.encode_texts:
        with open(a.encode_texts) as f:
            texts = json.load(f)
    buckets = tuple(int(x) for x in a.encode_buckets.split(","))
    mesh = make_mesh(MeshConfig(data=len(local) * (pg.size if pg else 1), shard=1), devices=local)
    with Window() as w:
        t0 = time.perf_counter()
        emb = encode_run(params, cfg, mesh, texts, a.encode_quant, a.encode_batch, buckets, dev)
        enc_s = time.perf_counter() - t0
    one = encode_run(params, cfg, None, texts, a.encode_quant, a.encode_batch, buckets, dev)
    res = {"shape": list(emb.shape), "finite": bool(np.isfinite(emb).all()),
           "min_cos_vs_one_device": float(np.min(np.sum(emb * one, axis=1))),
           "sha256": hashlib.sha256(emb.tobytes()).hexdigest(), "encode_s": enc_s,
           **w.report()}
    if emb.size <= 65_536:
        res["embeddings"] = emb.astype(np.float64).tolist()
    out["encode"] = res


def tp_params(a, name: str, cfg, dev):
    """A tower's full params (and LoRA adapters or None): `{name}.pt` (and
    `{name}_lora.pt`) under `--tp-params-dir`, else drawn from a generator
    seeded `--train-seed` on `dev`."""
    from theoremsearch_tpu_torch.encoder.families import family_module

    if a.tp_params_dir:
        path = os.path.join(a.tp_params_dir, f"{name}.pt")
        lpath = os.path.join(a.tp_params_dir, f"{name}_lora.pt")
        lora = torch.load(lpath, map_location=dev, weights_only=True) if os.path.exists(lpath) else None
        return torch.load(path, map_location=dev, weights_only=True), lora
    gen = torch.Generator(device=dev).manual_seed(a.train_seed)
    return family_module(cfg).init_params(cfg, gen, device=dev), None


def tp_encode(params, cfg, mesh, texts, a) -> np.ndarray:
    """`BatchedEncoder` on the tower's `shard_params` over `mesh` (the tp
    encode), or on the full params on one device when mesh is None."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.families import family_module

    buckets = tuple(int(x) for x in a.encode_buckets.split(","))
    if mesh is None:
        enc = BatchedEncoder(params, cfg, batch_size=a.encode_batch, buckets=buckets,
                             device=params["embed"].device)
    else:
        enc = BatchedEncoder(family_module(cfg).shard_params(params, mesh), cfg, mesh=mesh,
                             batch_size=a.encode_batch, buckets=buckets)
    return enc.encode(texts)


def min_cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.min(np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))))


def checkpoint_check(state, cfg, tcfg, dev, pg, directory: str) -> dict:
    """save_checkpoint of a (possibly row-split) state from every process;
    process 0 restores it into a one-device template and compares every
    leaf (params, moments, counts) with the state's logical leaves."""
    from theoremsearch_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from theoremsearch_tpu_torch.train.contrastive import init_train_state

    sync(dev)
    t0 = time.perf_counter()
    save_checkpoint(state, directory)
    save_s = time.perf_counter() - t0
    opt = state.opt_state
    want = [logical_leaves(t) for t in (state.params, opt.mu, opt.nu)]
    if pg.rank != 0:
        return {"save_s": save_s}
    template = init_train_state(cfg, tcfg, generator=torch.Generator(device=dev).manual_seed(12345),
                                device=dev)
    t0 = time.perf_counter()
    back = restore_checkpoint(directory, cfg, tcfg, template=template)
    restore_s = time.perf_counter() - t0
    got = [logical_leaves(t) for t in (back.params, back.opt_state.mu, back.opt_state.nu)]
    equal = all(len(g) == len(w) and all(x.dtype == y.dtype and torch.equal(x, y)
                                         for x, y in zip(g, w)) for g, w in zip(got, want))
    return {"save_s": save_s, "restore_s": restore_s, "leaves": sum(len(w) for w in want),
            "equal": bool(equal and back.step == state.step and back.opt_state.count == opt.count),
            "bytes": sum(t.numel() * t.element_size() for w in want for t in w)}


def tp_readings(run: dict, one: dict, params: list) -> dict:
    """`train_readings` of a tp run's logical `params` against the
    one-process run, and the param distance again over the leaves whose
    first gradient in the one-process run is not 0 to rounding (a norm
    above ZERO_GRAD_REL of the global one), with the count and element
    share of those left out. A leaf whose exact gradient is 0 (BERT's key
    bias: softmax removes a shift of every key score of a query) moves by
    the rounding noise in it, which AdamW scales up to whole steps and
    which the row's other summation order changes."""
    out = train_readings(run, one, distance(params, one["params"]))
    live = [n > ZERO_GRAD_REL * one["grad_norms"][0] for n in one["leaf_grad_norms"]]
    out["param_distance_rel_live"] = distance(
        [x for x, k in zip(params, live) if k],
        [y for y, k in zip(one["params"], live) if k]) / one["update_norm"]
    out["zero_grad_leaves"] = live.count(False)
    out["zero_grad_share"] = (sum(y.numel() for y, k in zip(one["params"], live) if not k)
                              / sum(y.numel() for y in one["params"]))
    out["min_leaf_grad_rel"] = min(one["leaf_grad_norms"]) / one["grad_norms"][0]
    out["min_live_leaf_grad_rel"] = min(n for n, k in zip(one["leaf_grad_norms"], live) if k) \
        / one["grad_norms"][0]
    return out


def part_tp(a, dev, local, pg, out) -> None:
    """Tensor parallelism on the `--tp-mesh` mesh, tower by tower (see the
    module docstring). Process 0 runs each piece again on a one-process
    mesh of the same shape (and the encode on one device) when
    `--check-one-process` names tp."""
    from theoremsearch_tpu_torch.core.config import MeshConfig, TrainConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    data, shard = (int(x) for x in a.tp_mesh.split(","))
    mesh = make_mesh(MeshConfig(data=data, shard=shard), devices=local)
    check = "tp" in a.check_one_process and pg.rank == 0
    one_mesh = local_mesh(data, shard, dev)
    texts = ENCODE_TEXTS
    if a.encode_texts:
        with open(a.encode_texts) as f:
            texts = json.load(f)
    towers = [t for t in a.tp_towers.split(",") if t]
    encode_n = dict(zip(towers, (int(x) for x in a.tp_encode_counts.split(",")))) \
        if a.tp_encode_counts else {}
    train_towers = set(a.tp_train_towers.split(",")) if a.tp_train_towers else set(towers)
    res = {"mesh": [data, shard], "layout": mesh.layout, "local_rows": mesh.local_rows,
           "local_shards": [s for s, _ in mesh.local_shards],
           "row_group_size": mesh.row_group.size if mesh.row_group is not None else 1,
           "column_group_size": mesh.column_group.size if mesh.column_group is not None else 1,
           "towers": {}}
    for name in towers:
        cfg = encoder_config(name)
        full, lora = tp_params(a, name, cfg, dev)
        r = {}
        n = encode_n.get(name, len(texts))
        if n:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            with Window() as w:
                emb = tp_encode(full, cfg, mesh, texts[:n], a)
            e = {"shape": list(emb.shape), "finite": bool(np.isfinite(emb).all()),
                 "sha256": hashlib.sha256(emb.tobytes()).hexdigest(), **w.report()}
            if dev.type == "cuda":
                e["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
            if emb.size <= 65_536:
                e["embeddings"] = emb.astype(np.float64).tolist()
            if check:
                one = tp_encode(full, cfg, one_mesh, texts[:n], a)
                e["equal_one_process"] = bool(np.array_equal(one, emb))
                e["min_cos_vs_one_process"] = min_cos(emb, one)
                e["min_cos_vs_one_device"] = min_cos(emb, tp_encode(full, cfg, None, texts[:n], a))
            r["encode"] = e
        if name in train_towers:
            batches = train_batches(a.train_steps, cfg.vocab_size, a.train_batch)
            tcfg = TrainConfig(batch_size=int(batches[0][0].shape[0]),
                               seq_len=int(batches[0][0].shape[1]), learning_rate=a.lr,
                               temperature=a.temperature)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            with Window() as w:
                t = train_run(cfg, tcfg, mesh, batches, a.train_seed, a.fused, dev,
                              keep_params=check, full=full, keep_state=a.tp_checkpoint)
            t.update(w.report())
            if dev.type == "cuda":
                t["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
            state = t.pop("state", None)
            one = None
            if check:
                mine = t.pop("params")
                one = train_run(cfg, tcfg, one_mesh, batches, a.train_seed, a.fused, dev,
                                keep_params=True, full=full)
                t["one_process"] = {k: one[k] for k in ("losses", "grad_norms", "update_norm")}
                t["vs_one_process"] = tp_readings(t, one, mine)
                t["equal_one_process"] = (one["losses"] == t["losses"]
                                          and one["params_sha256"] == t["params_sha256"])
            r["train"] = t
            if a.tp_checkpoint:
                r["checkpoint"] = checkpoint_check(state, cfg, tcfg, dev, pg,
                                                   os.path.join(a.workdir, f"tp_checkpoint_{name}"))
            del state
            if a.lora_steps:
                lb = batches[: a.lora_steps]
                lr_ = lora_run(cfg, tcfg, mesh, lb, a.train_seed, a.fused, full=full, lora=lora)
                if check:
                    lone = lora_run(cfg, tcfg, one_mesh, lb, a.train_seed, a.fused, full=full, lora=lora)
                    lr_["one_process_losses"] = lone["losses"]
                    lr_["max_loss_delta"] = max(abs(x - y) for x, y in zip(lr_["losses"], lone["losses"]))
                r["lora"] = lr_
            controls = {}
            for c in (c for t_, c in (x.split(":") for x in a.tp_controls.split(",") if x)
                      if t_ == name):
                with tp_control(c):
                    tc = train_run(cfg, tcfg, mesh, batches, a.train_seed, a.fused, dev,
                                   keep_params=check, full=full)
                controls[c] = {"losses": tc["losses"], "params_sha256": tc["params_sha256"]}
                if check:
                    controls[c]["vs_one_process"] = tp_readings(tc, one, tc.pop("params"))
            if controls:
                r["controls"] = controls
        res["towers"][name] = r
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["tp"] = res


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="init method: tcp://host:port or file://path")
    ap.add_argument("--out", required=True, help="the JSON result file")
    ap.add_argument("--device", default=None, help="this process's device (default: the card)")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    ap.add_argument("--local", type=int, default=4, help="mesh entries this process holds")
    ap.add_argument("--parts", default="search,routes,live,train,encode")
    ap.add_argument("--workdir", default=None, help="a directory every process can read")
    ap.add_argument("--check-one-process", default="",
                    help="parts (search, ivf, train, tp) to run again on a one-process mesh")
    ap.add_argument("--trace-dir", default=None,
                    help="trace one speed-path batch (utils/profiling.trace) into this directory")
    # search / routes / live
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--row-block", type=int, default=128, help="0: the engine's default")
    ap.add_argument("--rescore-factor", type=int, default=8)
    ap.add_argument("--recall-draws", type=int, default=0)
    ap.add_argument("--exact-batch", type=int, default=0)
    ap.add_argument("--time-iters", type=int, default=0)
    ap.add_argument("--live-adds", type=int, default=5)
    ap.add_argument("--live-deletes", type=int, default=2)
    ap.add_argument("--ivf-rows", type=int, default=0, help="rows of the ivf part's corpus")
    ap.add_argument("--ivf-batch", type=int, default=8)
    ap.add_argument("--ivf-nlist", type=int, default=16)
    ap.add_argument("--ivf-nprobe", type=int, default=4)
    # train
    ap.add_argument("--train-config", default="tiny_f32")
    ap.add_argument("--train-mesh", default="2,4")
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--train-batch", default=None, help="npz with q, p token arrays")
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--lora-steps", type=int, default=0, help="LoRA steps after the train part")
    ap.add_argument("--fused", default="on")
    ap.add_argument("--train-control", default="sum", choices=CONTROLS,
                    help="the gradient sum over processes, or a broken one (train_control)")
    # encode
    ap.add_argument("--encode-config", default="tiny")
    ap.add_argument("--encode-params", default=None, help="a torch.save'd params tree")
    ap.add_argument("--encode-seed", type=int, default=0)
    ap.add_argument("--encode-texts", default=None, help="a JSON list of texts")
    ap.add_argument("--encode-quant", default="none")
    ap.add_argument("--encode-batch", type=int, default=8)
    ap.add_argument("--encode-buckets", default="16")
    ap.add_argument("--search-mesh", default="", help="data,shard of the search part's mesh "
                    "(default: 1,world*local)")
    # tp
    ap.add_argument("--tp-mesh", default="1,2", help="data,shard of the tp part's mesh")
    ap.add_argument("--tp-towers", default="tiny_f32", help="configs (encoder_config names)")
    ap.add_argument("--tp-train-towers", default=None, help="the towers that train (default: all)")
    ap.add_argument("--tp-encode-counts", default="",
                    help="texts each tower encodes, in --tp-towers order (0: none; default: all)")
    ap.add_argument("--tp-params-dir", default=None, help="{name}.pt full params, {name}_lora.pt")
    ap.add_argument("--tp-checkpoint", action="store_true",
                    help="save the trained state; process 0 restores it on one device")
    ap.add_argument("--tp-controls", default="",
                    help=f"control runs, tower:control pairs (controls: {TP_CONTROLS})")
    a = ap.parse_args(argv)
    a.check_one_process = {p for p in a.check_one_process.split(",") if p}
    return a


def main(argv=None) -> int:
    a = parse(argv)
    sys.path.insert(0, ROOT)
    from theoremsearch_tpu_torch.core import distributed

    parts = [p for p in a.parts.split(",") if p]
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}")
    pg = distributed.initialize(a.init, a.world, a.rank, backend=a.backend, device=a.device,
                                timeout_s=COLLECTIVE_TIMEOUT_S)
    dev = pg.device
    if dev.type == "cpu":
        torch.set_num_threads(2)
    if dev.type == "cuda":
        from theoremsearch_tpu_torch.kernels import _build

        _build.load()
    local = [dev] * a.local
    out = {"rank": pg.rank, "world": pg.size, "backend": pg.backend, "device": str(dev)}
    fns = {"search": part_search, "routes": part_routes, "ivf": part_ivf, "live": part_live,
           "train": part_train, "encode": part_encode, "tp": part_tp}
    try:
        for p in parts:
            log(pg.rank, f"{p} ...")
            t0 = time.perf_counter()
            fns[p](a, dev, local, pg, out)
            out[p]["part_s"] = time.perf_counter() - t0
            log(pg.rank, f"{p} done in {out[p]['part_s']:.1f} s")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        distributed.barrier(pg)
    finally:
        distributed.shutdown()
    with open(a.out, "w") as f:
        json.dump(out, f)
    return 0


def launch(cmds: list[list[str]], logdir: str, timeout: float, name: str = "proc") -> list[str]:
    """Run `python *cmd` for every command at once from the repository
    root (the root on PYTHONPATH, no JAX_PLATFORMS: the port imports no
    jax), each one's output into `logdir`/{name}{i}.log, and wait for all
    under one deadline of `timeout` seconds. Returns the logs. Raises
    RuntimeError with every log's tail when a process exits nonzero or
    the deadline passes; every process still running is killed first."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    paths = [os.path.join(logdir, f"{name}{i}.log") for i in range(len(cmds))]
    procs = []
    try:
        for c, path in zip(cmds, paths):
            with open(path, "w") as f:
                procs.append(subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait()
    logs = []
    for path in paths[: len(procs)]:
        with open(path) as f:
            logs.append(f.read())
    if hung or any(p.returncode for p in procs):
        tails = "\n".join(f"--- {name}{i} (rc {p.returncode})\n{log[-3000:]}"
                          for i, (p, log) in enumerate(zip(procs, logs)))
        raise RuntimeError(f"{len(hung)} of {len(procs)} processes killed at the {timeout} s "
                           f"deadline, rc {[p.returncode for p in procs]}\n{tails}")
    return logs


def run_workers(argvs: list[list[str]], workdir: str, timeout: float,
                name: str = "worker") -> list[dict]:
    """One process of this module an argv (its `--out` added), run by
    `launch`; their JSON results in order."""
    outs = [os.path.join(workdir, f"{name}{i}.json") for i in range(len(argvs))]
    launch([[os.path.abspath(__file__), *a, "--out", o] for a, o in zip(argvs, outs)], workdir,
           timeout, name)
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


if __name__ == "__main__":
    sys.exit(main())
