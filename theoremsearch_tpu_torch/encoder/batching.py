"""Batched, padding-bucketed encoder inference on one device (port of
theoremsearch_tpu/encoder/batching.py).

Texts are bucketed by token length into a few padded widths and batches
pad to power-of-two sizes, so the forward sees a bounded set of shapes;
results come back in input order, L2-normalized f32. `encode_device`
keeps the result on the device for the scan (one host sync per serving
batch, at the results). Kernel launches are asynchronous, so the host
prepares sub-batch i+1 while the card runs sub-batch i without a
prefetch thread.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..core.config import EncoderConfig
from ..utils.shapes import pow2_bucket
from .model import Params, encode_pooled
from .tokenizer import SimpleTokenizer

DEFAULT_BUCKETS = (64, 128, 256, 512)


class BatchedEncoder:
    def __init__(
        self,
        params: Params,
        cfg: EncoderConfig,
        tokenizer=None,
        mesh=None,
        batch_size: int = 64,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        prompts: dict | None = None,
        quant: str = "none",
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device encoding is not ported yet")
        if quant == "int8":
            raise NotImplementedError("the int8 encoder mode is not ported yet")
        if quant != "none":
            raise ValueError(f"unknown quant mode {quant!r}")
        if not isinstance(cfg, EncoderConfig):
            raise NotImplementedError(f"the {type(cfg).__name__} tower is not ported yet")
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["embed"].device
        self.tokenizer = tokenizer or SimpleTokenizer(vocab_size=cfg.vocab_size)
        self.prompts = dict(prompts or {})
        self.batch_size = batch_size
        self.buckets = tuple(sorted(b for b in buckets if b <= cfg.max_seq_len)) or (
            cfg.max_seq_len,
        )

    def _bucket_for(self, n_tokens: int) -> int:
        for b in self.buckets:
            if n_tokens <= b:
                return b
        return self.buckets[-1]

    def _apply_prompt(self, texts: Sequence[str], role: str | None) -> list:
        pre = self.prompts.get(role) if role else None
        return [pre + t for t in texts] if pre else list(texts)

    def for_role(self, role: str):
        """encode() with a fixed role prompt ("query" / "document")."""
        return functools.partial(self.encode, role=role)

    @torch.inference_mode()
    def _forward(self, ids_mask: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(ids_mask)
        if self.device.type == "cuda":
            # a pageable upload waits for all queued device work; a pinned
            # one is enqueued behind it and the host goes on
            t = t.pin_memory().to(self.device, non_blocking=True)
        return encode_pooled(self.params, t[0], t[1], self.cfg)

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
        if len(idx) < b_pad:
            pad = b_pad - len(idx)
            ids = np.concatenate([ids, np.zeros((pad, width), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad, width), np.int32)])
            mask[len(idx):, 0] = 1  # avoid fully-empty rows
        return np.stack([ids, mask]).astype(np.int32), len(idx)

    def _run(self, texts: list[str]) -> list[tuple[list[int], torch.Tensor]]:
        """Dispatch every sub-batch; (input indices, device embeddings)."""
        tokenized = [self.tokenizer.tokenize(t) for t in texts]
        if len(texts) <= self.batch_size:
            order = list(range(len(texts)))
        else:
            order = sorted(range(len(texts)), key=lambda i: len(tokenized[i]))
        pieces = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            ids_mask, n_real = self._prep_batch(texts, tokenized, idx)
            pieces.append((idx, self._forward(ids_mask)[:n_real]))
        return pieces

    def encode_device(self, texts: Sequence[str], role: str | None = None) -> torch.Tensor:
        """Like encode(), but the (n_pad, D) f32 result stays on the
        device; n_pad is len(texts) padded up to a power of two and rows
        beyond len(texts) are junk (empty-string embeddings)."""
        if not len(texts):
            return torch.zeros((0, self.cfg.embedding_dim), device=self.device)
        n = len(texts)
        n_pad = pow2_bucket(n)
        texts = self._apply_prompt(texts, role) + [""] * (n_pad - n)
        pieces = self._run(texts)
        if len(pieces) == 1:
            return pieces[0][1].float()
        out = torch.zeros((n_pad, self.cfg.embedding_dim), device=self.device)
        for idx, emb in pieces:
            out[torch.as_tensor(idx, device=self.device)] = emb.float()
        return out

    def encode(self, texts: Sequence[str], role: str | None = None) -> np.ndarray:
        """(len(texts), embedding_dim) f32 on the host, normalized per config."""
        if not len(texts):
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        out = np.zeros((len(texts), self.cfg.embedding_dim), np.float32)
        for idx, emb in self._run(self._apply_prompt(texts, role)):
            out[idx] = emb.float().cpu().numpy()
        return out
