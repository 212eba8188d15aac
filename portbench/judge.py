"""The numbers that decide `correct`, from what the window produced and
the plain reference (`reference/`).

- `cos_gap`: the widest 1 - cos between an embedding the program made
  and the float32 reference's embedding of the same tokens.
- `recall_miss`: 1 - the mean recall@k of the returned ids against the
  exact top-k over the corpus rows, for the same query vectors.
- `score_gap`: the widest gap between a returned score and the exact
  score of the returned id.
"Exact" is the speed route's rescore as the configuration states it:
the corpus's bf16 rows (`stack.Corpus`) against the query rounded to
bf16, products summed in float32 with TF32 off, over every row.
- `rank_errors`: returned ids that are missing or lie outside the exact
  top-(DEPTH x k): an answer that is not a near neighbour at all (exact
  count, limit 0).
The control's readings come from the same functions, with the reference
in the program's place at int8 (`search_control`)."""

from __future__ import annotations

import numpy as np
import torch

from .reference.search import exact_topk, int8_blocks, scores_of

DEPTH = 10


def cos_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    a = prog.double() / prog.double().norm(dim=1, keepdim=True).clamp(min=1e-300)
    b = ref.double() / ref.double().norm(dim=1, keepdim=True)
    return float((1.0 - (a * b).sum(dim=1)).max())


def rescore_query(q: torch.Tensor) -> torch.Tensor:
    """The query as the bf16 rescore takes it, in float32."""
    return q.bfloat16().float()


def search_numbers(q: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor, corpus,
                   k: int, exact=None) -> dict:
    """Judge returned (ids, scores) (B, k) for queries q (B, D) f32 against
    the exact top-k over `corpus` (a stack.Corpus); -1 ids are misses."""
    if exact is None:
        exact = exact_deep(q, corpus, k)
    deep = exact[1].cpu().numpy()
    ex_i = deep[:, :k]
    got = ids.cpu().numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ex_i, got))
    far = sum(len(set(b.tolist()) - set(a.tolist())) for a, b in zip(deep, got))
    valid = ids >= 0
    ref_s = scores_of(rescore_query(q), ids.clamp(min=0).to(q.device), corpus.rows)
    gap = torch.where(valid.to(q.device), (scores.to(q.device).float() - ref_s).abs(),
                      torch.full_like(ref_s, float("inf")))
    return {"recall_miss": 1.0 - hits / float(ex_i.size), "score_gap": float(gap.max()),
            "rank_errors": float(far)}


def search_control(q: torch.Tensor, corpus, k: int, exact=None) -> dict:
    """The control of the search stage: the reference in the program's
    place at int8 (the corpus at one global int8 scale, exact top-k over
    it), judged as the program is."""
    qblocks, _ = int8_blocks(corpus.blocks)
    s, i = exact_topk(rescore_query(q), qblocks, k)
    return search_numbers(q, i, s, corpus, k, exact=exact)


def exact_deep(q: torch.Tensor, corpus, k: int):
    """The exact top-(DEPTH x k) of q over the corpus: (scores, rows)."""
    return exact_topk(rescore_query(q), corpus.blocks, DEPTH * k)


def np_sample(n: int, size: int, rng: np.random.Generator, must: int) -> np.ndarray:
    """`size` indices of n drawn by the rng, always with `must` among them."""
    pick = rng.choice(n, min(size, n), replace=False)
    if must not in pick:
        pick[0] = must
    return np.sort(pick)
