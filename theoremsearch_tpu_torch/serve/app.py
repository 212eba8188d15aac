"""Serving layer (port of theoremsearch_tpu/serve/app.py): the reference
streamlit_app.py feature set as a UI-agnostic service.

Covers: encoder loading, TTL-cached facet loads (authors, tags-per-source,
theorem count — streamlit_app.py:70-116), the full filter set, both
ranking modes (pure vector / citation-weighted), latest-slogan selection
(handled at index-build time via the catalog's latest-slogan queue),
LaTeX display cleanup, and a working feedback store (the reference's
save_feedback is a stub, streamlit_app.py:145-147). Live updates go to
the engine, which does not serve them yet (NotImplementedError).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np

from ..search.engine import SearchEngine
from ..search.filters import SearchFilters, parse_paper_filter
from .latex_display import clean_latex_for_display

FACET_TTL_S = 24 * 3600  # reference caches facets for 24h


class _TTLCache:
    def __init__(self, ttl_s: float = FACET_TTL_S):
        self.ttl = ttl_s
        self._store: dict[str, tuple[float, Any]] = {}

    def get(self, key: str, compute: Callable[[], Any]):
        now = time.time()
        hit = self._store.get(key)
        if hit and now - hit[0] < self.ttl:
            return hit[1]
        val = compute()
        self._store[key] = (now, val)
        return val


class SearchService:
    """encode -> engine.search -> cleaned, display-ready results."""

    def __init__(
        self,
        engine: SearchEngine,
        encode_fn: Callable[[list[str]], np.ndarray],
        feedback_path: str | None = None,
        scheduler=None,
        request_timeout: float = 60.0,
    ):
        """scheduler: optional serve.scheduler.BatchScheduler (built with
        an encode_fn). When present, search_and_display routes through it:
        concurrent HTTP requests micro-batch both the encoder forward and
        the corpus scan, and its max_pending admission control applies
        (SchedulerOverloaded -> HTTP 429)."""
        self.engine = engine
        self.encode = encode_fn
        self.scheduler = scheduler
        self.request_timeout = request_timeout
        self._facets = _TTLCache()
        self._feedback_path = feedback_path

    # ---------------- facets ----------------

    def load_theorem_count(self) -> int:
        # num_live is an in-memory property tracking live adds/deletes
        # (the reference counts the live theorem table) — read it
        # directly rather than TTL-caching: mutations that bypass this
        # service (the CLI's catalog-refresh thread mutates the engine)
        # would otherwise leave /health and /metrics stale for 24h
        return self.engine.num_live

    def load_authors(self) -> list[str]:
        meta = self.engine.meta
        return self._facets.get("authors", meta.load_authors) if meta else []

    def load_tags_per_source(self) -> dict[str, list[str]]:
        meta = self.engine.meta
        return self._facets.get("tags", meta.load_tags_per_source) if meta else {}

    # ---------------- search ----------------

    def search_and_display(
        self, query: str, filters: SearchFilters | dict | None = None
    ) -> list[dict[str, Any]]:
        """The search_and_display core (streamlit_app.py:165) minus the
        widget rendering: returns result dicts with a `display_markdown`
        field of cleaned LaTeX."""
        if isinstance(filters, dict):
            filters = _filters_from_ui(filters)
        filters = filters or SearchFilters()
        if not filters.sources:
            return []
        if self.scheduler is not None:
            # batched serving path: the scheduler micro-batches this
            # request's encode+scan with concurrent ones
            fut = self.scheduler.submit_text(
                query or "", k=self.engine.search_pool_k(filters), filters=filters
            )
            scores, ids = fut.result(self.request_timeout)
            rows = self.engine.rank_results(
                scores, ids, float(filters.citation_weight), int(filters.top_k)
            )
        else:
            qvec = np.asarray(self.encode([query or ""]))[0]
            rows = self.engine.search(qvec, filters)
        for r in rows:
            r["display_markdown"] = clean_latex_for_display(r.get("theorem_body", ""))
        return rows

    def search_batch(
        self,
        queries: Sequence[str],
        filters: SearchFilters | None = None,
        k: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched vector interface for throughput serving: amortizes the
        corpus scan over many queries per kernel launch (the property the
        QPS target depends on, SURVEY.md §7.4)."""
        qvecs = np.asarray(self.encode(list(queries)))
        return self.engine.search_vectors(qvecs, k=k, filters=filters)

    # ---------------- live updates ----------------

    def index_documents(self, docs: Sequence[dict]) -> list[int]:
        """Upsert new theorems into the LIVE index: encode each doc's
        slogan (the reference embeds slogans — generate_embeddings feeds
        theorem_slogan rows) and add to the engine's delta buffer. The
        docs are searchable by the next query. Returns assigned doc ids."""
        texts = [
            d.get("slogan") or d.get("theorem_body") or d.get("theorem_name") or ""
            for d in docs
        ]
        emb = np.asarray(self.encode(list(texts)))
        meta_rows = list(docs) if self.engine.meta is not None else None
        ids = self.engine.add_documents(emb, meta_rows=meta_rows)
        return [int(i) for i in ids]

    def delete_documents(self, doc_ids: Sequence[int]) -> int:
        """Tombstone docs by id; they stop appearing immediately."""
        return self.engine.delete_documents(list(doc_ids))

    def load_live_count(self) -> int:
        return self.engine.num_live

    # ---------------- feedback ----------------

    def save_feedback(
        self,
        feedback: str,
        query: str,
        url: str,
        theorem_name: str,
        filters: SearchFilters | None = None,
        text: str | None = None,
    ) -> bool:
        """Thumbs-up/down persistence (implemented, unlike the reference
        stub). `text` is the voted result's slogan/body — the usable
        InfoNCE positive for train --feedback (the theorem NAME alone is
        boilerplate). Returns whether the vote was actually written (a
        service without feedback_path drops votes; callers must not
        claim otherwise)."""
        import json

        record = {
            "time": time.time(),
            "feedback": feedback,
            "query": query,
            "url": url,
            "theorem_name": theorem_name,
            "text": text,
            "filters": (filters.__dict__ if filters else {}),
        }
        if not self._feedback_path:
            return False
        with open(self._feedback_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=list) + "\n")
        return True


def _filters_from_ui(d: dict) -> SearchFilters:
    """Translate the reference UI's filters dict (streamlit_app.py:448-536
    widget state) into SearchFilters."""
    pf = d.get("paper_filter")
    if isinstance(pf, str):
        pf = parse_paper_filter(pf)
    # ranges arrive as JSON LISTS over HTTP; filter_key() hashes them,
    # so they must be tuples (a list here 500'd every scheduler-routed
    # range-filtered request)
    yr = d.get("year_range")
    cr = d.get("citation_range")
    return SearchFilters(
        sources=tuple(d.get("sources", ("arXiv", "Stacks Project"))),
        authors=tuple(d.get("authors", ())),
        tags=tuple(d.get("tags", ())),
        year_range=tuple(yr) if yr else None,
        journal_status=d.get("journal_status", "All"),
        paper_filter=pf or {"ids": set(), "titles": set()},
        types=tuple(d.get("types", ())),
        citation_range=tuple(cr) if cr else None,
        include_unknown_citations=d.get("include_unknown_citations", True),
        top_k=int(d.get("top_k", 10)),
        citation_weight=float(d.get("citation_weight", 0.0)),
    )
