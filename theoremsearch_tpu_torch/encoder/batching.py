"""Batched, padding-bucketed encoder inference (port of
theoremsearch_tpu/encoder/batching.py), for the four towers: the config's
type picks the model module (`towers.tower_module`: qwen, gemma, BERT or
the port's deepseek tower).

On a mesh (`mesh=`; the reference shards the batch over its `data` axis)
each sub-batch is padded to a multiple of the data axis, split over it,
run on each data row and the pooled rows are gathered in order on the
mesh's first device. With full params (the reference's GSPMD replicates
them, so the `shard` axis computes nothing new) the parameters, and in
int8 mode the codes quantized once, are copied once to every distinct
data device. With params placed by the tower's `shard_params` each data
row runs the tensor-parallel forward over its shard devices
(`encoder/sharding.py`). int8 on a mesh with `shard` > 1 raises, as the
reference's does: the tp rules have no int8 form. On a mesh across
processes (`core/meshes.py`, after `core/distributed.py:initialize`) the
batch is split over the global data rows and each process encodes the
rows it runs: its whole rows (int8 too: such a mesh with `shard` 1 is
dp-only), or, where a row spans processes, every process of the row the
same slice through the row's tp forward. The pooled rows are
all-gathered over the mesh's column group, so `encode` / `encode_device`
return the whole batch on every process (the reference's
`out_shardings=P()`). Every choice of a sub-batch's shape (bucket,
padding, split) is made from the texts alone, so the processes of a row
run collectives of the same shapes.

Texts are bucketed by token length into a few padded widths and batches
pad to power-of-two sizes, so the forward sees a bounded set of shapes;
results come back in input order, L2-normalized f32. `encode_device`
keeps the result on the device for the scan (one host sync per serving
batch, at the results). Kernel launches are asynchronous, so the host
prepares sub-batch i+1 while the card runs sub-batch i without a
prefetch thread.

`stats()` counts the work since construction (monotonic, under a lock):
calls, texts, sub-batches, the token slots the forward ran (B_pad x W
a sub-batch, the power-of-two rows included), the real tokens among
them (the mask over the real rows) and the sub-batches by (B_pad, W).
The host's stages run under the spans `ts.encoder.tokenize`,
`ts.encoder.pad` (a sub-batch's `_prep_batch`), `ts.encoder.forward`
(its upload and the launch of the tower) and `ts.encoder.to_host` (the
copies back in `encode`, where the host waits on the card):
`utils/profiling.py:span`.

The deepseek tower routes only the real tokens: each sub-batch's rows of
them (its real rows' mask, on the host) are uploaded with the ids, so
its forward reads nothing back. Its expert layers add to one
`deepseek.MoECounters` a width bucket (`stats()["moe"]`), and
`start_routing_record()` / `stop_routing_record()` keep each sub-batch's
picks (the records, off by default). It runs on one device, in bf16.
"""

from __future__ import annotations

import functools
import threading
from typing import Sequence

import numpy as np
import torch

from ..core.distributed import all_gather
from ..utils.device import resolve_device, upload
from ..utils.profiling import span
from ..utils.shapes import pow2_bucket
from ..kernels.layer_int8 import kernel_layout
from .deepseek import MoECounters, real_token_rows
from .model import Params
from .sharding import is_sharded, row_params, unshard_params
from .tokenizer import SimpleTokenizer
from .towers import routes_real_tokens, tower_module

DEFAULT_BUCKETS = (64, 128, 256, 512)


def _to_device(tree, dev: torch.device):
    """A copy of a nested dict / list / tuple of tensors on `dev` (a
    tensor already there is shared)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree


class BatchedEncoder:
    def __init__(
        self,
        params: Params,
        cfg,
        tokenizer=None,
        mesh=None,
        batch_size: int = 64,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        prompts: dict | None = None,
        quant: str = "none",
        device=None,
    ):
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        sharded = is_sharded(params)
        if mesh is None and sharded:
            mesh = params["embed"].mesh
        if mesh is not None and quant == "int8" and mesh.shape.get("shard", 1) > 1:
            raise ValueError("quant='int8' supports single-chip or dp-only meshes "
                             "(no tp sharding rules for the int8 weights)")
        if sharded and quant == "int8":     # a one-shard placement: the full params
            params, sharded = unshard_params(params), False
        self.mesh = mesh
        self.cfg = cfg
        self._mod = tower_module(cfg)
        self._routed = routes_real_tokens(cfg)
        if self._routed and (mesh is not None or sharded):
            raise ValueError("the deepseek tower runs on one device (no mesh, no tp placement)")
        if mesh is not None:
            self.device = mesh.first_device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device={device} disagrees with the mesh's first device {self.device}")
            if sharded and params["embed"].count != mesh.shape[mesh.axis_names[1]]:
                raise ValueError(f"params sharded {params['embed'].count} ways do not fit "
                                 f"the mesh {mesh.shape}")
            if not sharded:
                params = _to_device(params, self.device)
        else:
            self.device = torch.device(device) if device is not None else params["embed"].device
        self.params = params
        # int8 (w8a8) serving mode, qwen and gemma towers: weights quantized
        # once here; each (batch, width) bucket whose shapes qualify runs
        # the whole-layer kernels B3 and B4 (the tower's `_fused_layer_ok`),
        # the rest the int8 op-chain. The BERT tower (biased projections)
        # has no int8 form.
        self.qlayers = None
        if quant == "int8":
            if not hasattr(self._mod, "quantize_params_int8"):
                raise ValueError(f"quant='int8' is not supported for the {type(cfg).__name__} family")
            self.qlayers = self._mod.quantize_params_int8(params)
            if self.device.type == "cuda":
                self.qlayers = kernel_layout(self.qlayers)
        # one (device, params, qlayers) a data row this process runs:
        # sharded params as the row reads them; full params copied once to
        # each distinct device (a device repeated on the axis shares its
        # copy). The batch splits over all data rows (every process's).
        data_devices = mesh.data_devices if mesh is not None else [self.device]
        self._n_data = mesh.shape[mesh.axis_names[0]] if mesh is not None else 1
        self._local_rows = mesh.local_rows if mesh is not None else [0]
        self._group = mesh.column_group if mesh is not None else None
        if sharded:
            self._rows = [(dev, row_params(params, mesh, r), None)
                          for r, dev in zip(self._local_rows, data_devices)]
        else:
            copies = {self.device: (self.params, self.qlayers)}
            for dev in data_devices:
                if dev not in copies:
                    copies[dev] = (_to_device(self.params, dev), _to_device(self.qlayers, dev))
            self._rows = [(dev, *copies[dev]) for dev in data_devices]
        self.tokenizer = tokenizer or SimpleTokenizer(vocab_size=cfg.vocab_size)
        self.prompts = dict(prompts or {})
        self.batch_size = batch_size
        self.buckets = tuple(sorted(b for b in buckets if b <= cfg.max_seq_len)) or (
            cfg.max_seq_len,
        )
        self._stats_lock = threading.Lock()
        self._stats = {"calls": 0, "texts": 0, "sub_batches": 0, "token_slots": 0,
                       "real_tokens": 0}
        self._by_shape: dict[tuple[int, int], int] = {}
        self._moe: dict[int, MoECounters] = {}     # a width bucket's expert-layer counters
        self._routing: list | None = None

    def stats(self) -> dict:
        """Counts since construction: calls, texts, sub_batches,
        token_slots (sum of B_pad x W), real_tokens (the mask over the real
        rows) and by_shape ({(B_pad, W): sub-batches}); for the deepseek
        tower also moe ({W: launches, pairs, real_tokens, experts_touched,
        max_rows}: `deepseek.MoECounters.read`, which waits for the card)."""
        with self._stats_lock:
            out = {**self._stats, "by_shape": dict(self._by_shape)}
        if self._routed:
            out["moe"] = {w: c.read() for w, c in sorted(self._moe.items())}
        return out

    def start_routing_record(self) -> None:
        """Keep each sub-batch's picks from now on (deepseek tower): one
        record a sub-batch, {"rows": the call's input indices of its real
        rows, "lengths": their real tokens, "picks": (n_moe_layers, T, k)
        uint8 on the card, T the real tokens row after row}."""
        if not self._routed:
            raise ValueError("only the deepseek tower routes tokens")
        self._routing = []

    def stop_routing_record(self) -> list:
        """The records since `start_routing_record`; recording stops."""
        out, self._routing = self._routing or [], None
        return out

    def _count_call(self, n_texts: int) -> None:
        with self._stats_lock:
            self._stats["calls"] += 1
            self._stats["texts"] += n_texts

    def _count_sub_batch(self, ids_mask: np.ndarray, n_real: int) -> None:
        _, b_pad, width = ids_mask.shape
        real = int(ids_mask[1, :n_real].sum())
        with self._stats_lock:
            self._stats["sub_batches"] += 1
            self._stats["token_slots"] += b_pad * width
            self._stats["real_tokens"] += real
            self._by_shape[(b_pad, width)] = self._by_shape.get((b_pad, width), 0) + 1

    def _bucket_for(self, n_tokens: int) -> int:
        for b in self.buckets:
            if n_tokens <= b:
                return b
        return self.buckets[-1]

    def encode_long(self, texts: Sequence[str], chunk_tokens: int | None = None,
                    role: str | None = None) -> np.ndarray:
        """Long-document encoding: a text longer than `chunk_tokens`
        (default: the widest bucket less the two specials) is split into
        chunks, each chunk encoded as usual, and the chunk embeddings
        mean-pooled and renormalized.

        The role prompt is applied once, before chunking, so it lands in
        the first chunk (sentence-transformers prompts the full text and
        then truncates). Words are accumulated greedily by their actual
        token counts: one token-dense formula "word" can be many tokens,
        and a chunk past the bucket would be truncated in _prep_batch."""
        chunk_tokens = chunk_tokens or (self.buckets[-1] - 2)
        texts = self._apply_prompt(texts, role)
        pieces: list[str] = []
        owners: list[int] = []
        for i, t in enumerate(texts):
            if len(self.tokenizer.tokenize(t)) <= chunk_tokens:
                pieces.append(t)
                owners.append(i)
                continue
            cur: list[str] = []
            cur_tokens = 0
            for w in t.split() or [t]:
                wt = len(self.tokenizer.tokenize(w))
                if cur and cur_tokens + wt > chunk_tokens:
                    pieces.append(" ".join(cur))
                    owners.append(i)
                    cur, cur_tokens = [], 0
                cur.append(w)
                cur_tokens += wt
            if cur:
                pieces.append(" ".join(cur))
                owners.append(i)
        emb = self.encode(pieces)
        out = np.zeros((len(texts), self.cfg.embedding_dim), np.float32)
        counts = np.zeros(len(texts))
        for j, owner in enumerate(owners):
            out[owner] += emb[j]
            counts[owner] += 1
        out /= np.maximum(counts[:, None], 1)
        if self.cfg.normalize:
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        return out

    def _apply_prompt(self, texts: Sequence[str], role: str | None) -> list:
        pre = self.prompts.get(role) if role else None
        return [pre + t for t in texts] if pre else list(texts)

    def for_role(self, role: str):
        """encode() with a fixed role prompt ("query" / "document")."""
        return functools.partial(self.encode, role=role)

    @torch.inference_mode()
    def _forward(self, ids_mask: np.ndarray, n_real: int | None = None,
                 idx: list | None = None) -> torch.Tensor:
        """Pooled rows of one padded sub-batch (2, B, W), on self.device:
        split over the data axis (B is a multiple of its size), one
        forward a data row this process runs, gathered in order (over the
        mesh's column group when other processes run other rows). The
        first n_real rows (default: all) are real, input indices idx."""
        if self._routed:
            return self._forward_routed(ids_mask, ids_mask.shape[1] if n_real is None else n_real,
                                        idx)
        parts = np.split(ids_mask, self._n_data, axis=1)
        outs = []
        for (dev, params, qlayers), r in zip(self._rows, self._local_rows):
            t = upload(parts[r], dev)
            kw = {} if qlayers is None else {"qlayers": qlayers, "fused_layers": True}
            outs.append(self._mod.encode_pooled(params, t[0], t[1], self.cfg, **kw)
                        .to(self.device, non_blocking=True))
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        if self._group is not None:
            out = torch.cat(all_gather(out, self._group))
        return out

    def _forward_routed(self, ids_mask: np.ndarray, n_real: int, idx) -> torch.Tensor:
        """The deepseek tower's forward: the real rows' real tokens (from
        the host mask) ride in the ids' upload."""
        w = ids_mask.shape[2]
        rows = real_token_rows(ids_mask[1, :n_real])
        buf = upload(np.concatenate([ids_mask.reshape(-1), rows]), self.device)
        t = buf[: ids_mask.size].view(ids_mask.shape)
        counters = self._moe.get(w)
        if counters is None:
            counters = self._moe[w] = MoECounters(self.device)
        record = [] if self._routing is not None else None
        out = self._mod.encode_pooled(self.params, t[0], t[1], self.cfg, tokens=buf[ids_mask.size :],
                                      counters=counters, record=record)
        if record:
            self._routing.append({"rows": list(idx if idx is not None else range(n_real)),
                                  "lengths": ids_mask[1, :n_real].sum(axis=1).tolist(),
                                  "picks": record[0]})
        return out

    def _prep_batch(self, texts, tokenized, idx):
        """Pad one sub-batch to its (batch-bucket, width-bucket) shape:
        (ids_mask (2, B, W) int32 host array, n_real)."""
        longest = max(len(tokenized[i]) for i in idx) + 2  # specials
        width = self._bucket_for(longest)
        if hasattr(self.tokenizer, "encode_pretokenized"):
            enc = self.tokenizer.encode_pretokenized([tokenized[i] for i in idx], pad_to=width)
        else:
            enc = self.tokenizer([texts[i] for i in idx], max_length=width, pad_to=width)
        ids, mask = enc.input_ids, enc.attention_mask
        b_pad = min(pow2_bucket(len(idx)), self.batch_size)
        # the data axis splits the batch: round the bucket up to its size
        n_data = self._n_data
        b_pad = -(-max(b_pad, len(idx)) // n_data) * n_data
        if len(idx) < b_pad:
            pad = b_pad - len(idx)
            ids = np.concatenate([ids, np.zeros((pad, width), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad, width), np.int32)])
            mask[len(idx):, 0] = 1  # avoid fully-empty rows
        return np.stack([ids, mask]).astype(np.int32), len(idx)

    def _run(self, texts: list[str]) -> list[tuple[list[int], torch.Tensor]]:
        """Dispatch every sub-batch; (input indices, device embeddings)."""
        with span("ts.encoder.tokenize"):
            tokenized = [self.tokenizer.tokenize(t) for t in texts]
            if len(texts) <= self.batch_size:
                order = list(range(len(texts)))
            else:
                order = sorted(range(len(texts)), key=lambda i: len(tokenized[i]))
        pieces = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            with span("ts.encoder.pad"):
                ids_mask, n_real = self._prep_batch(texts, tokenized, idx)
                self._count_sub_batch(ids_mask, n_real)
            with span("ts.encoder.forward"):
                pieces.append((idx, self._forward(ids_mask, n_real, idx)[:n_real]))
        return pieces

    def encode_device(self, texts: Sequence[str], role: str | None = None) -> torch.Tensor:
        """Like encode(), but the (n_pad, D) f32 result stays on the
        device; n_pad is len(texts) padded up to a power of two and rows
        beyond len(texts) are junk (empty-string embeddings)."""
        if not len(texts):
            return torch.zeros((0, self.cfg.embedding_dim), device=self.device)
        n = len(texts)
        self._count_call(n)
        n_pad = pow2_bucket(n)
        texts = self._apply_prompt(texts, role) + [""] * (n_pad - n)
        pieces = self._run(texts)
        if len(pieces) == 1:
            return pieces[0][1].float()
        out = torch.zeros((n_pad, self.cfg.embedding_dim), device=self.device)
        for idx, emb in pieces:
            out[upload(np.asarray(idx, np.int64), self.device)] = emb.float()
        return out

    def encode(self, texts: Sequence[str], role: str | None = None) -> np.ndarray:
        """(len(texts), embedding_dim) f32 on the host, normalized per config."""
        if not len(texts):
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        self._count_call(len(texts))
        out = np.zeros((len(texts), self.cfg.embedding_dim), np.float32)
        pieces = self._run(self._apply_prompt(texts, role))
        with span("ts.encoder.to_host"):
            for idx, emb in pieces:
                out[idx] = emb.float().cpu().numpy()
        return out
