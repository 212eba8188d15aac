"""Exact brute-force inner-product oracle (port of
theoremsearch_tpu/eval/oracle.py).

fp32 with TF32 off — the reference's Precision.HIGHEST: a TF32 "exact"
oracle would be a 10-bit-mantissa one, and the recall gate measured
against it would favour rescore paths whose errors correlate with it.
The corpus is streamed in row chunks, so a corpus held on the host never
has to fit on the device whole.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device, tf32_off


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def exact_sim_matrix(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) inner products in fp32."""
    with tf32_off():
        return queries.float() @ corpus.float().T


def exact_topk(
    queries, corpus, k: int = 10, *, device=None, chunk_rows: int = 32_768, mask=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by inner product: (scores (Q, k) f32, ids (Q, k) int32),
    computed on `device` (default: the card; pass "cpu" for a CPU run),
    corpus chunk by chunk. `mask` (N,) bool, True = row passes, restricts
    the search to the passing rows (the filtered gate); slots beyond the
    passing rows are (-inf, -1)."""
    q = _as_tensor(queries)
    dev = resolve_device(device)
    q = q.to(dev).float()
    c = _as_tensor(corpus)
    keep = None if mask is None else _as_tensor(np.asarray(mask, dtype=bool))
    n = c.shape[0]
    k = min(k, n)
    top_s = torch.full((q.shape[0], k), float("-inf"), device=dev)
    top_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for i in range(0, n, chunk_rows):
        s = exact_sim_matrix(q, c[i : i + chunk_rows].to(dev))
        if keep is not None:
            s = torch.where(keep[i : i + chunk_rows].to(dev), s, float("-inf"))
        cs, ci = torch.topk(s, min(k, s.shape[1]), dim=1)
        all_s = torch.cat([top_s, cs], dim=1)
        all_i = torch.cat([top_i, ci + i], dim=1)
        top_s, sel = torch.topk(all_s, k, dim=1)
        top_i = torch.gather(all_i, 1, sel)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s.cpu().numpy(), top_i.to(torch.int32).cpu().numpy()


def l2_normalize(x, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Rows (or slices along `axis`) scaled to unit L2 norm in f32, on the
    input's device: the reference's normalize_embeddings=True."""
    x = _as_tensor(x).float()
    return x / torch.clamp(torch.linalg.norm(x, dim=axis, keepdim=True), min=eps)
