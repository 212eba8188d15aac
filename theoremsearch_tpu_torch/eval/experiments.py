# Verbatim copy of theoremsearch_tpu/eval/experiments.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Embedder experiments — comparison harness and corpus visualization.

Capability-parity with the reference's experiments/ directory
(SURVEY.md component 23): side-by-side embedder evaluation on the
validation set (the workflow that produced "Qwen3 0.6B is the best of
three embedders", compare_embeddings.py:463-466) and the IncrementalPCA
cluster plot with stratified reservoir sampling
(experiments/pca_plotting.py:42-110).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from .harness import evaluate_encoder_on_validation


@dataclass
class EmbedderResult:
    name: str
    metrics: dict[str, float]


def compare_embedders(
    encoders: Mapping[str, Callable[[list[str]], np.ndarray] | tuple],
    validation_path: str | Path,
    context_window: str = "body-and-summary-v1",
    top_k_report: int = 5,
) -> list[EmbedderResult]:
    """Evaluate each named encoder on the validation set; sorted by H@k
    descending (the reference's selection criterion). A value may be a
    single callable or a (query_encode, doc_encode) pair — required for
    asymmetric-prompt checkpoints (embeddinggemma / qwen-instruct),
    whose documents must NOT carry the query prefix."""
    out = []
    for name, enc in encoders.items():
        q_enc, d_enc = enc if isinstance(enc, tuple) else (enc, None)
        metrics = evaluate_encoder_on_validation(
            q_enc, validation_path, context_window, top_k_report,
            doc_encode_fn=d_enc,
        )
        out.append(EmbedderResult(name=name, metrics=metrics))
    out.sort(key=lambda r: -r.metrics.get(f"H@{top_k_report}", 0.0))
    return out


def best_embedder(results: Sequence[EmbedderResult]) -> str:
    return results[0].name if results else ""


# ---------------------------------------------------------------------------
# stratified reservoir sampling + incremental PCA plot
# ---------------------------------------------------------------------------


def stratified_reservoir(
    items: Iterable[tuple[str, int]],
    per_stratum: int,
    seed: int = 0,
) -> dict[str, list[int]]:
    """Classic reservoir sampling per stratum over a single stream of
    (stratum, doc_id) — bounded memory over an arbitrarily large corpus."""
    rng = random.Random(seed)
    reservoirs: dict[str, list[int]] = {}
    seen: dict[str, int] = {}
    for stratum, doc in items:
        n = seen.get(stratum, 0) + 1
        seen[stratum] = n
        res = reservoirs.setdefault(stratum, [])
        if len(res) < per_stratum:
            res.append(doc)
        else:
            j = rng.randrange(n)
            if j < per_stratum:
                res[j] = doc
    return reservoirs


def pca_project(
    embeddings: np.ndarray,
    n_components: int = 2,
    batch_size: int = 4096,
) -> np.ndarray:
    """IncrementalPCA projection (sklearn when available, exact SVD
    fallback) — the dimensionality reduction behind the cluster plot."""
    x = np.asarray(embeddings, np.float32)
    try:
        from sklearn.decomposition import IncrementalPCA

        ipca = IncrementalPCA(n_components=n_components, batch_size=max(batch_size, 2 * n_components))
        return ipca.fit_transform(x)
    except ImportError:
        xc = x - x.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        return xc @ vt[:n_components].T


def plot_category_clusters(
    embeddings: np.ndarray,
    categories: Sequence[str],
    out_path: str | Path,
    per_stratum: int = 500,
    seed: int = 0,
) -> Path:
    """PCA scatter of embeddings colored by category, saved to out_path
    (PNG). Samples per_stratum docs per category first."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    reservoirs = stratified_reservoir(
        ((c, i) for i, c in enumerate(categories)), per_stratum, seed
    )
    idx = np.array([i for res in reservoirs.values() for i in res])
    labels = [categories[i] for i in idx]
    proj = pca_project(np.asarray(embeddings)[idx])

    fig, ax = plt.subplots(figsize=(10, 8))
    uniq = sorted(set(labels))
    cmap = matplotlib.colormaps["tab20"].resampled(max(len(uniq), 1))
    for ci, cat in enumerate(uniq):
        sel = np.array([l == cat for l in labels])
        ax.scatter(proj[sel, 0], proj[sel, 1], s=4, color=cmap(ci), label=cat, alpha=0.6)
    ax.legend(markerscale=3, fontsize=7, ncol=2)
    ax.set_title("Theorem embeddings — PCA by category")
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
