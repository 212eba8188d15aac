# Verbatim copy of theoremsearch_tpu/eval/harness.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Validation-set harness.

Loads the hand-labeled validation set (73 query->theorem rows; format of
/root/reference/validation_set.csv: columns query, theorem, paper,
paper_id, per-prompt slogan variants, body), builds qrels with the
reference's grading (compare_embeddings.py:453-457: exact match=1, same
paper=0.5, else 0), and evaluates any (encoder, index) pair against both
the IR metric suite and the recall-vs-exact gate.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from .metrics import Qrels, evaluate_retrieval, recall_vs_exact
from .oracle import exact_topk

DEFAULT_CONTEXT_WINDOW = "body-and-summary-v1"  # compare_embeddings.py:432


@dataclass(frozen=True)
class ValidationExample:
    query: str
    theorem: str        # theorem name, e.g. "Theorem 1.2."
    paper: str          # paper title
    paper_id: str       # e.g. "2509.14145"
    slogan: str         # the slogan text for the chosen context window
    body: str           # raw LaTeX body


def load_validation_set(
    path: str | Path,
    context_window: str = DEFAULT_CONTEXT_WINDOW,
) -> list[ValidationExample]:
    """Parse the validation CSV; rows lacking the chosen slogan column are
    dropped (reference: vals[vals[context_window].notnull()],
    compare_embeddings.py:436)."""
    out: list[ValidationExample] = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            slogan = (row.get(context_window) or "").strip()
            if not slogan:
                continue
            out.append(
                ValidationExample(
                    query=row["query"],
                    theorem=row["theorem"],
                    paper=row["paper"],
                    paper_id=row["paper_id"],
                    slogan=slogan,
                    body=row.get("body", "") or "",
                )
            )
    return out


def build_qrels(
    examples: Sequence[ValidationExample],
    corpus_paper_ids: Sequence[str],
    corpus_keys: Sequence[tuple[str, str]] | None = None,
) -> Qrels:
    """Grade docs per query: exact (paper_id, theorem-name) match = 1,
    same-paper = 0.5, else 0.

    corpus_paper_ids: paper_id per corpus doc (for the 0.5 grade —
    reference _generate_qrels, compare_embeddings.py:175-182).
    corpus_keys: optional (paper_id, theorem_name) per doc for the exact
    grade (reference qrels_array construction, :440-442). When None, the
    corpus is assumed to be exactly the validation slogans in order
    (doc i == query i).
    """
    qrels: dict[int, dict[int, float]] = {}
    for qi, ex in enumerate(examples):
        grades: dict[int, float] = {}
        for di, pid in enumerate(corpus_paper_ids):
            if pid == ex.paper_id:
                grades[di] = 0.5
        if corpus_keys is None:
            grades[qi] = 1.0
        else:
            for di, (pid, name) in enumerate(corpus_keys):
                if pid == ex.paper_id and name == ex.theorem:
                    grades[di] = 1.0
                    break
        qrels[qi] = grades
    return qrels


def evaluate_encoder_on_validation(
    encode_fn: Callable[[list[str]], np.ndarray],
    validation_path: str | Path,
    context_window: str = DEFAULT_CONTEXT_WINDOW,
    top_k_report: int = 5,
    doc_encode_fn: Callable[[list[str]], np.ndarray] | None = None,
) -> dict[str, float]:
    """End-to-end IR evaluation: encode queries + slogans, exact cosine
    ranking, the full reference metric suite. Mirrors
    compare_embeddings.py evaluate_retrieval (:55-92) with the corpus =
    the validation slogans themselves. Asymmetric-prompt checkpoints
    (embeddinggemma / qwen-instruct) pass their document encoder as
    doc_encode_fn; queries always go through encode_fn."""
    examples = load_validation_set(validation_path, context_window)
    q_emb = np.asarray(encode_fn([ex.query for ex in examples]))
    s_emb = np.asarray((doc_encode_fn or encode_fn)([ex.slogan for ex in examples]))
    # normalize BEFORE ranking: an encoder returning unnormalized
    # embeddings would otherwise be ranked by document norm, not angle
    # (the reference uses util.cos_sim, compare_embeddings.py:61)
    q_emb = q_emb / np.maximum(np.linalg.norm(q_emb, axis=1, keepdims=True), 1e-12)
    s_emb = s_emb / np.maximum(np.linalg.norm(s_emb, axis=1, keepdims=True), 1e-12)
    sim = q_emb @ s_emb.T
    qrels = build_qrels(examples, [ex.paper_id for ex in examples])
    metrics = evaluate_retrieval(sim, qrels, top_k_report=top_k_report)
    metrics["num_queries"] = float(len(examples))
    return metrics


def recall_gate(
    query_vecs: np.ndarray,
    corpus_vecs: np.ndarray,
    approx_ids: np.ndarray,
    k: int = 10,
) -> float:
    """recall@k of an approximate search result vs the exact oracle on the
    same vectors — the driver-set acceptance gate (>=0.99 @ k=10)."""
    _, exact_ids = exact_topk(query_vecs, corpus_vecs, k=k)
    return recall_vs_exact(approx_ids, exact_ids, k=k)
