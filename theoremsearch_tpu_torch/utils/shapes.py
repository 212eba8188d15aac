# Verbatim copy of theoremsearch_tpu/utils/shapes.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Shared shape-bucketing helpers.

The pow2-with-floor bucket is load-bearing across serving: every device
shape (encoder batch, scatter updates, query batches) must come from a
BOUNDED set or each new size costs a 30-120 s remote compile that stalls
the pipeline. One helper instead of hand-rolled loops in encoder/
batching.py, search/engine.py and serve/scheduler.py keeps the contract
(floor 8, powers of two) in one place.
"""

from __future__ import annotations


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power-of-two >= max(n, 1), floored at `floor`."""
    b = floor
    while b < n:
        b *= 2
    return b


def round_up(n: int, m: int) -> int:
    """Round n up to the next multiple of m."""
    return ((n + m - 1) // m) * m
