# Verbatim copy of theoremsearch_tpu/train/data.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Training-pair plumbing for contrastive fine-tuning.

Pairs come from the places the deployment already has labeled text:
- the validation CSV's (query, slogan) rows (the reference's only
  labeled relevance data, validation_set.csv);
- the catalog's latest slogans paired with their theorem bodies
  (slogan <-> statement is a natural positive pair: both describe the
  same theorem);
- the feedback log's thumbs-up (query, theorem) pairs
  (serve/app.py:save_feedback JSONL).

Tokenization goes through the SAME tokenizer the encoder serves with,
padded to the train config's fixed seq_len (static shapes for the
jitted step).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np


def pairs_from_validation(validation_path: str | Path, context_window: str) -> list[tuple[str, str]]:
    from ..eval.harness import load_validation_set

    examples = load_validation_set(validation_path, context_window)
    return [(ex.query, ex.slogan) for ex in examples]


def pairs_from_catalog(catalog, limit: int | None = None) -> list[tuple[str, str]]:
    """Latest slogan per theorem paired with the theorem body."""
    sql = (
        "SELECT s.slogan, t.body FROM theorem_slogan s "
        "JOIN theorem t ON t.theorem_id = s.theorem_id "
        "WHERE s.slogan_id IN (SELECT MAX(slogan_id) FROM theorem_slogan "
        "GROUP BY theorem_id)"
    )
    if limit is not None:
        sql += f" LIMIT {int(limit)}"
    return [(r[0], r[1]) for r in catalog.conn.execute(sql) if r[0] and r[1]]


def pairs_from_feedback(feedback_path: str | Path) -> list[tuple[str, str]]:
    """Thumbs-up (query, positive-text) rows from the feedback JSONL.

    The positive is the record's `text` field (slogan/body captured at
    vote time — serve/app.py:save_feedback); rows without it are SKIPPED
    rather than paired with the theorem *name*, which is boilerplate
    ('Theorem 1.') that would train queries toward label strings."""
    p = Path(feedback_path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if r.get("feedback") == "up" and r.get("query") and r.get("text"):
            out.append((r["query"], r["text"]))
    return out


def negatives_from_feedback(feedback_path: str | Path) -> list[tuple[str, str]]:
    """Thumbs-DOWN (query, text) rows — served as explicit hard
    negatives for InfoNCE (contrastive.info_nce_loss n_ids/n_mask)."""
    p = Path(feedback_path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if r.get("feedback") == "down" and r.get("text"):
            out.append((r.get("query", ""), r["text"]))
    return out


def tokenize_pairs(
    pairs: Sequence[tuple[str, str]], tokenizer, seq_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(q_ids, q_mask, p_ids, p_mask) int32 arrays at static seq_len."""
    q_enc = tokenizer([a for a, _ in pairs], max_length=seq_len, pad_to=seq_len)
    p_enc = tokenizer([b for _, b in pairs], max_length=seq_len, pad_to=seq_len)
    return (
        np.asarray(q_enc.input_ids, np.int32),
        np.asarray(q_enc.attention_mask, np.int32),
        np.asarray(p_enc.input_ids, np.int32),
        np.asarray(p_enc.attention_mask, np.int32),
    )


def batch_iterator(
    arrays: tuple[np.ndarray, ...],
    batch_size: int,
    steps: int,
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, ...]]:
    """`steps` shuffled fixed-size batches, cycling over the pair set
    (with replacement across epochs; batches are always full so the
    jitted step compiles one shape)."""
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("no training pairs")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    for _ in range(steps):
        if pos + batch_size > n:
            order = rng.permutation(n)
            pos = 0
        if batch_size > n:
            idx = rng.integers(0, n, size=batch_size)
        else:
            idx = order[pos : pos + batch_size]
            pos += batch_size
        yield tuple(a[idx] for a in arrays)
