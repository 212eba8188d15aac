# Verbatim copy of theoremsearch_tpu/eval/metrics.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""IR metrics, vectorized.

Port of the metric *semantics* of the reference evaluation harness
(reference: compare_embeddings.py — precision_at_k :95, hit_at_k :120,
mrr_at_k :143, ndcg_at_k :216, err_at_k :257, q_measure_at_k :315),
re-implemented vectorized over the whole query set instead of per-query
Python loops. Graded gains use 2^rel - 1 with a max-grade normalizer for
ERR/Q-measure, exactly as the reference.

Note: the reference marks the exact-match document via `qrels[i][j] = 1`
(grading map compare_embeddings.py:453-457); its notebook cell at :450-451
contains a no-op (`qrels_table[i][qrels_array[i][1]]` without assignment) —
we implement the documented intent (exact=1, paper=0.5, none=0).

qrels format matches the reference: {query_idx: {doc_idx: grade}}.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

Qrels = Mapping[int, Mapping[int, float]]


def _rank_docs(sim_matrix: np.ndarray) -> np.ndarray:
    """Doc indices by descending score per query (ties: lowest index first,
    matching np.argsort(-row, kind='stable') which the reference's argsort
    approximates)."""
    return np.argsort(-sim_matrix, axis=1, kind="stable")


def _qrels_to_dense(qrels: Qrels, num_queries: int, num_docs: int) -> np.ndarray:
    rel = np.zeros((num_queries, num_docs), dtype=np.float64)
    for q, docs in qrels.items():
        for d, g in docs.items():
            rel[q, d] = g
    return rel


def _exact_doc_per_query(qrels: Qrels, num_queries: int) -> np.ndarray:
    """The unique doc with grade == 1 per query (reference convention,
    compare_embeddings.py:111)."""
    out = np.full(num_queries, -1, dtype=np.int64)
    for q in range(num_queries):
        for d, g in qrels.get(q, {}).items():
            if g == 1:
                out[q] = d
                break
    return out


def precision_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int = 5) -> float:
    """Mean (hit in top-k)/k for the single grade-1 doc. Reference :95-117."""
    ranked = _rank_docs(sim_matrix)[:, :k]
    correct = _exact_doc_per_query(qrels, sim_matrix.shape[0])
    hits = (ranked == correct[:, None]).any(axis=1)
    return float(np.mean(hits / k))


def hit_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int = 5) -> float:
    """Mean hit-rate of the grade-1 doc in top-k. Reference :120-140."""
    ranked = _rank_docs(sim_matrix)[:, :k]
    correct = _exact_doc_per_query(qrels, sim_matrix.shape[0])
    return float(np.mean((ranked == correct[:, None]).any(axis=1).astype(np.float64)))


def mrr_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int | None = None) -> float:
    """Mean reciprocal rank of the grade-1 doc (0 if outside cutoff).
    Reference :143-173."""
    ranked = _rank_docs(sim_matrix)
    if k is not None:
        ranked = ranked[:, :k]
    correct = _exact_doc_per_query(qrels, sim_matrix.shape[0])
    eq = ranked == correct[:, None]
    any_hit = eq.any(axis=1)
    first = np.where(any_hit, eq.argmax(axis=1) + 1, 0)
    rr = np.where(any_hit, 1.0 / np.maximum(first, 1), 0.0)
    return float(np.mean(rr))


def _gains(rels: np.ndarray, gain: str = "exp") -> np.ndarray:
    if gain == "exp":
        return np.power(2.0, rels) - 1.0
    if gain == "linear":
        return rels.astype(np.float64)
    raise ValueError(f"Unknown gain scheme: {gain}")


def ndcg_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int = 10, gain: str = "exp") -> float:
    """nDCG@k with exponential gains. Reference :216-243 (argsorts the raw
    sim matrix itself, so we accept scores, not pre-ranked lists)."""
    nq, nd = sim_matrix.shape
    rel = _qrels_to_dense(qrels, nq, nd)
    ranked = _rank_docs(sim_matrix)[:, :k]
    rels_at = np.take_along_axis(rel, ranked, axis=1)
    discounts = 1.0 / np.log2(np.arange(2, rels_at.shape[1] + 2))
    dcg = (_gains(rels_at, gain) * discounts).sum(axis=1)
    ideal = -np.sort(-rel, axis=1)[:, :k]
    idcg = (_gains(ideal, gain) * discounts[: ideal.shape[1]]).sum(axis=1)
    out = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-30), 0.0)
    return float(np.mean(out))


def err_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int = 10, max_rel: float | None = None) -> float:
    """Expected reciprocal rank with satisfaction p = (2^rel - 1)/2^R.
    Reference :257-311."""
    nq, nd = sim_matrix.shape
    rel = _qrels_to_dense(qrels, nq, nd)
    if max_rel is None:
        max_rel = float(rel.max())
        if max_rel <= 0.0:
            return 0.0
    denom = 2.0 ** max_rel
    ranked = _rank_docs(sim_matrix)[:, :k]
    rels_at = np.take_along_axis(rel, ranked, axis=1)
    ps = (np.power(2.0, rels_at) - 1.0) / denom
    # ERR_q = sum_i prod_{j<i}(1-p_j) * p_i / i  — cumulative product shifted right
    not_sat = np.cumprod(1.0 - ps, axis=1)
    prev_not_sat = np.concatenate([np.ones((nq, 1)), not_sat[:, :-1]], axis=1)
    inv_rank = 1.0 / np.arange(1, ps.shape[1] + 1)
    err = (prev_not_sat * ps * inv_rank).sum(axis=1)
    # queries with empty qrels score 0 (reference :285-287)
    has_rels = np.array([bool(qrels.get(q)) for q in range(nq)])
    return float(np.mean(np.where(has_rels, err, 0.0)))


def q_measure_at_k(sim_matrix: np.ndarray, qrels: Qrels, k: int = 10, max_rel: float | None = None) -> float:
    """Sakai's Q-measure over normalized exponential gains. Reference :315-371.

    Faithful to the reference's formulation: for retrieved docs in the
    top-k (positive-gain only), Q = sum_i g_i * (CG_i / i) / CG*, where i
    is the 1-based *rank in the top-k list* (zero-gain positions still
    consume a rank) and CG* sums gains over all graded docs for the query.
    """
    nq, nd = sim_matrix.shape
    rel = _qrels_to_dense(qrels, nq, nd)
    if max_rel is None:
        max_rel = float(rel.max())
        if max_rel <= 0.0:
            return 0.0
    denom = 2.0 ** max_rel
    ranked = _rank_docs(sim_matrix)[:, :k]
    rels_at = np.take_along_axis(rel, ranked, axis=1)
    gains_k = (np.power(2.0, rels_at) - 1.0) / denom
    cg = np.cumsum(gains_k, axis=1)
    ranks = np.arange(1, gains_k.shape[1] + 1, dtype=np.float64)
    q_sum = np.where(gains_k > 0, gains_k * (cg / ranks), 0.0).sum(axis=1)
    gains_all = (np.power(2.0, rel) - 1.0) / denom
    cg_star = gains_all.sum(axis=1)
    out = np.where(cg_star > 0, q_sum / np.maximum(cg_star, 1e-30), 0.0)
    return float(np.mean(out))


def recall_vs_exact(approx_ids: np.ndarray, exact_ids: np.ndarray, k: int = 10) -> float:
    """Recall@k of an approximate index vs the exact brute-force oracle.

    This is the rebuild's acceptance gate (BASELINE.md: >=0.99 recall@10);
    the reference has no ANN index so its 'recall' is identically 1.

    approx_ids, exact_ids: (num_queries, >=k) arrays of doc ids.
    """
    a = approx_ids[:, :k]
    e = exact_ids[:, :k]
    # fraction of VALID exact top-k retrieved by approx top-k, per query.
    # PAD_ID (-1) slots (fewer than k docs pass a filter / tiny corpora)
    # must not count as matches or the >=0.99 gate inflates.
    valid = e >= 0
    matches = ((a[:, :, None] == e[:, None, :]) & valid[:, None, :]).any(axis=1)
    n_valid = valid.sum(axis=1)
    per_q = matches.sum(axis=1) / np.maximum(n_valid, 1)
    per_q = np.where(n_valid > 0, per_q, 1.0)
    return float(per_q.mean())


def evaluate_retrieval(
    sim_matrix: np.ndarray,
    qrels: Qrels,
    top_k_report: int = 5,
) -> dict[str, float]:
    """Compute the reference's full metric suite (compare_embeddings.py:55-92):
    P@1, Hit@k, MRR@k (binary) and nDCG@k, ERR@k, Q-measure@k (graded)."""
    return {
        "P@1": precision_at_k(sim_matrix, qrels, k=1),
        f"H@{top_k_report}": hit_at_k(sim_matrix, qrels, k=top_k_report),
        f"MRR@{top_k_report}": mrr_at_k(sim_matrix, qrels, k=top_k_report),
        f"nDCG@{top_k_report}": ndcg_at_k(sim_matrix, qrels, k=top_k_report),
        f"ERR@{top_k_report}": err_at_k(sim_matrix, qrels, k=top_k_report),
        f"Q@{top_k_report}": q_measure_at_k(sim_matrix, qrels, k=top_k_report),
    }
