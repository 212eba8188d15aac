# Verbatim copy of theoremsearch_tpu/utils/gc_tuning.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""GC discipline for the serving path.

The c128 serving p99 tail (SERVE_BENCH_r03: p99 5-10x p50) was ONE
cause: a CPython gen-2 garbage-collection pass every ~10 s scanning the
session's permanent object graph — the corpus metadata's millions of
Python strings (`CorpusMetadata.paper_id` et al.), the encoder param
pytree, the scheduler rings — freezing every thread (dispatch included)
for its full duration. Stage traces put the entire tail in queue_ms
(~280-390 ms at 1M rows) with encode/scan/sync nominal, and
experiments/exp_serve_tail.py discriminated the suspects on-chip with a
watchdog thread + gc callbacks: baseline 458 passes / worst 82 ms /
5 global freezes per 12 s window at 262k rows; after ``gc.freeze()``
the worst pass is 3 ms, freezes drop to zero, and e2e p99 falls from
2.7x to 1.4x p50. Disabling GC entirely scores the same but leaks
cycles; freezing keeps collection ON for post-startup garbage.

Call :func:`freeze_permanent` once after the long-lived serving objects
exist (engine + encoder + scheduler constructed, buckets warmed).
Objects created afterwards are collected normally; live-added metadata
simply becomes scannable garbage again until the next call.
"""

from __future__ import annotations

import gc


def freeze_permanent(collect: bool = True) -> dict:
    """Move every currently-live object into CPython's permanent
    generation so periodic collections stop scanning them.

    Runs one full collection first (anything unreachable now should die
    rather than be frozen forever) unless ``collect=False`` — a full
    pass over a large graph is itself a stop-the-world; re-tiering
    calls made WHILE SERVING (e.g. after a compact() fold) pass False
    and accept that any cyclic garbage alive at that instant is frozen
    (reference-counted objects — numpy/jax buffers — free normally
    either way; only unreachable *cycles* would leak, and the serving
    paths don't build them at scale).

    Idempotent; cheap to call again after large post-startup
    allocations to re-tier the new long-lived objects.

    Returns {"collected": n, "frozen": n} for logging.
    """
    collected = gc.collect() if collect else 0
    gc.freeze()
    return {"collected": collected, "frozen": gc.get_freeze_count()}


def refreeze_if_frozen() -> bool:
    """Maintain the freeze discipline after replacing long-lived state:
    if this process previously opted in via :func:`freeze_permanent`,
    re-tier the current graph (no collection pass — see above); if it
    never froze, do nothing, so library code can call this without
    imposing GC policy on embedders/notebooks. Returns whether it ran.

    SearchEngine.compact() calls this after its state swap — the fold
    allocates replacement multi-GB host arrays that would otherwise
    re-enter every gen-2 scan and bring back the ~300 ms serving
    stalls the startup freeze removed."""
    if gc.get_freeze_count() == 0:
        return False
    freeze_permanent(collect=False)
    return True
