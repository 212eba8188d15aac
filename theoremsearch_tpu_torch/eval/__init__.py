"""Port of theoremsearch_tpu.eval (see the package docstring)."""

from .harness import ValidationExample, build_qrels, load_validation_set
from .metrics import (
    err_at_k,
    evaluate_retrieval,
    hit_at_k,
    mrr_at_k,
    ndcg_at_k,
    precision_at_k,
    q_measure_at_k,
    recall_vs_exact,
)
from .oracle import exact_sim_matrix, exact_topk

__all__ = [
    "precision_at_k",
    "hit_at_k",
    "mrr_at_k",
    "ndcg_at_k",
    "err_at_k",
    "q_measure_at_k",
    "recall_vs_exact",
    "evaluate_retrieval",
    "exact_topk",
    "exact_sim_matrix",
    "load_validation_set",
    "build_qrels",
    "ValidationExample",
]
