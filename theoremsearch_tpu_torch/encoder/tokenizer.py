# Verbatim copy of theoremsearch_tpu/encoder/tokenizer.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Tokenization for the encoder.

Two backends:
- HFTokenizer: wraps a local HuggingFace tokenizer (tokenizer.json) when
  model assets are available on disk — required for parity with the
  reference's 'Qwen/Qwen3-Embedding-0.6B' checkpoints.
- SimpleTokenizer: dependency-free deterministic fallback (regex word /
  math-symbol split, hashed into a fixed vocab) so the full pipeline —
  encode, index, search, eval — runs hermetically (e.g. in CI and in this
  zero-egress environment). Hash tokenization preserves exact-token
  overlap, which is what the retrieval-machinery tests need.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z]+|[0-9]+|\\[A-Za-z]+|[^\sA-Za-z0-9]")


@dataclass
class Encoding:
    input_ids: np.ndarray       # (B, S) int32
    attention_mask: np.ndarray  # (B, S) int32


class SimpleTokenizer:
    """Deterministic hash tokenizer with BOS=1/EOS=2/PAD=0 conventions."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    n_special = 3

    def __init__(self, vocab_size: int = 151_669, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self._cache: dict[str, int] = {}

    def _tok_id(self, tok: str) -> int:
        # token -> id is deterministic; the memo turns the per-token
        # blake2s into a dict hit for the (heavily repeated) live vocab
        cached = self._cache.get(tok)
        if cached is not None:
            return cached
        h = hashlib.blake2s(tok.encode("utf-8"), digest_size=8).digest()
        v = self.n_special + int.from_bytes(h, "little") % (self.vocab_size - self.n_special)
        if len(self._cache) < 1_000_000:
            self._cache[tok] = v
        return v

    def tokenize(self, text: str) -> list[int]:
        if self.lowercase:
            text = text.lower()
        return [self._tok_id(t) for t in _TOKEN_RE.findall(text)]

    def __call__(
        self,
        texts: list[str],
        max_length: int = 512,
        pad_to: int | None = None,
    ) -> Encoding:
        return self.encode_pretokenized(
            [self.tokenize(t) for t in texts], max_length=max_length, pad_to=pad_to
        )

    def encode_pretokenized(
        self,
        token_lists: list[list[int]],
        max_length: int = 512,
        pad_to: int | None = None,
    ) -> Encoding:
        """Assemble BOS/ids/EOS/pad from ALREADY-tokenized lists — the
        ONE place the special-token layout lives. The batching layer
        tokenizes once for length bucketing and reuses the lists here
        (re-tokenizing measured as a visible share of the serving
        encoder stage)."""
        limit = min(max_length, pad_to) if pad_to else max_length
        seqs = [
            [self.bos_id] + ids[: limit - 2] + [self.eos_id]
            for ids in token_lists
        ]
        width = pad_to or max(len(s) for s in seqs)
        batch = np.full((len(seqs), width), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            batch[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return Encoding(batch, mask)


class HFTokenizer:
    """Thin wrapper over transformers.AutoTokenizer for real checkpoints."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, trust_remote_code=False)
        self.pad_id = self.tk.pad_token_id or 0
        self._affix: tuple[list[int], list[int]] | None = None

    def _special_affixes(self) -> tuple[list[int], list[int]]:
        """(prefix_ids, suffix_ids) the tokenizer's template wraps around
        a single sequence, derived EMPIRICALLY (fast tokenizers apply
        specials through the tokenizer.json post_processor, which
        build_inputs_with_special_tokens does not see)."""
        if self._affix is None:
            probe = self.tk("a", add_special_tokens=False)["input_ids"]
            full = self.tk("a", add_special_tokens=True)["input_ids"]
            self._affix = ([], [])
            for i in range(len(full) - len(probe) + 1):
                if full[i : i + len(probe)] == probe:
                    self._affix = (full[:i], full[i + len(probe):])
                    break
        return self._affix

    def tokenize(self, text: str) -> list[int]:
        """Token ids without padding/specials — used by the batching
        layer's length-bucketing (BatchedEncoder.encode)."""
        return self.tk(text, add_special_tokens=False)["input_ids"]

    def __call__(self, texts, max_length: int = 512, pad_to: int | None = None) -> Encoding:
        out = self.tk(
            texts,
            padding="max_length" if pad_to else "longest",
            truncation=True,
            max_length=pad_to or max_length,
            return_tensors="np",
        )
        return Encoding(
            out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)
        )

    def encode_pretokenized(
        self,
        token_lists: list[list[int]],
        max_length: int = 512,
        pad_to: int | None = None,
    ) -> Encoding:
        """Batch from ALREADY-tokenized id lists (no second pass over the
        raw text): truncate content to leave room for the tokenizer's
        special tokens, then wrap with the empirically-derived template
        affixes — equivalent to __call__ for single-sequence
        right-truncation (asserted in tests/test_hf_tokenizer.py)."""
        pre, post = self._special_affixes()
        limit = (min(max_length, pad_to) if pad_to else max_length) - len(pre) - len(post)
        seqs = [pre + ids[:limit] + post for ids in token_lists]
        width = pad_to or max(len(s) for s in seqs)
        batch = np.full((len(seqs), width), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            batch[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return Encoding(batch, mask)


def get_tokenizer(model_path: str | None = None, vocab_size: int = 151_669):
    """HF tokenizer when local assets exist, hermetic fallback otherwise."""
    if model_path and Path(model_path).exists():
        try:
            return HFTokenizer(model_path)
        except Exception:
            pass
    return SimpleTokenizer(vocab_size=vocab_size)
