# Verbatim copy of theoremsearch_tpu/search/filters.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Structured filters compiled to per-doc boolean masks.

Replicates the 10-filter WHERE builder of the reference
(streamlit_app.py:175-243) with identical semantics, but instead of SQL
the filters compile to a packed (N,) bool mask on the host; the engine
turns it into a -inf additive bias streamed through the MIPS kernel, so
filtered search keeps static shapes for XLA (SURVEY.md §7.4 "masked
scoring rather than pre-filtering").
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .metadata import CorpusMetadata

# reference streamlit_app.py:40-42
ALLOWED_TYPES = ["theorem", "lemma", "proposition", "corollary"]

# reference streamlit_app.py:44-47
ARXIV_ID_RE = re.compile(
    r"(?:arxiv\.org/(?:abs|pdf)/)?((?:\d{4}\.\d{4,5}|[a-z\-]+/\d{7}))",
    re.IGNORECASE,
)


def infer_type(name: str) -> str:
    """First ALLOWED_TYPE substring of the theorem name, default 'theorem'
    (reference streamlit_app.py:61-68)."""
    if not name:
        return "theorem"
    lower = name.lower()
    for t in ALLOWED_TYPES:
        if t in lower:
            return t
    return "theorem"


def extract_arxiv_id(s: str) -> str | None:
    if not s:
        return None
    m = ARXIV_ID_RE.search(s.strip())
    return m.group(1) if m else None


def normalize_title(s: str) -> str:
    return (s or "").casefold().strip()


def parse_paper_filter(raw: str) -> dict:
    """Comma-separated arXiv ids / title substrings
    (reference streamlit_app.py parse_paper_filter)."""
    ids, titles = set(), set()
    if not raw:
        return {"ids": ids, "titles": titles}
    for token in [t.strip() for t in raw.split(",") if t.strip()]:
        arx = extract_arxiv_id(token)
        if arx:
            ids.add(arx.lower())
        else:
            titles.add(normalize_title(token))
    return {"ids": ids, "titles": titles}


@dataclass
class SearchFilters:
    """The filter set of the reference UI (streamlit_app.py:178-243)."""

    sources: Sequence[str] = ("arXiv", "Stacks Project")
    authors: Sequence[str] = ()
    tags: Sequence[str] = ()
    year_range: tuple[int, int] | None = None
    journal_status: str = "All"        # All | Journal Article | Preprint Only
    paper_filter: dict = field(default_factory=lambda: {"ids": set(), "titles": set()})
    types: Sequence[str] = ()
    citation_range: tuple[int, int] | None = None
    include_unknown_citations: bool = True
    top_k: int = 10
    citation_weight: float = 0.0

    @property
    def is_default(self) -> bool:
        return (
            set(self.sources) == {"arXiv", "Stacks Project"}
            and not self.authors
            and not self.tags
            and self.year_range is None
            and self.journal_status == "All"
            and not self.paper_filter.get("ids")
            and not self.paper_filter.get("titles")
            and not self.types
            and self.citation_range is None
            and self.include_unknown_citations
        )


def compile_filter_mask(f: SearchFilters, meta: CorpusMetadata) -> np.ndarray | None:
    """(N,) bool mask, True = doc passes. None when no filtering is needed
    (saves the bias stream entirely)."""
    if f.is_default:
        return None

    n = len(meta)
    mask = np.ones(n, dtype=bool)
    is_arx = meta.is_arxiv

    # Source (streamlit_app.py:179-188): OR of selected source predicates
    srcs = set(f.sources)
    if not srcs:
        return np.zeros(n, dtype=bool)   # reference refuses to search; engine returns empty
    if srcs != {"arXiv", "Stacks Project"}:
        src_mask = np.zeros(n, dtype=bool)
        if "arXiv" in srcs:
            src_mask |= is_arx
        if "Stacks Project" in srcs:
            src_mask |= ~is_arx
        mask &= src_mask

    # Authors (:191-193): array overlap (&&)
    if f.authors:
        want = set(f.authors)
        mask &= np.array([bool(want.intersection(a or [])) for a in meta.authors])

    # Tags (:196-198): primary_category = ANY
    if f.tags:
        want = set(f.tags)
        mask &= np.array([c in want for c in meta.primary_category])

    # Year (:201-206): bounded for arXiv docs, non-arXiv always passes
    if f.year_range is not None:
        y0, y1 = f.year_range
        in_range = (meta.year >= y0) & (meta.year <= y1)
        mask &= np.where(is_arx, in_range, True)

    # Journal status (:209-213): arXiv-only predicate ANDed in, so
    # non-arXiv docs are excluded when a status is chosen
    has_journal = np.array([bool(j) for j in meta.journal_ref])
    if f.journal_status == "Journal Article":
        mask &= is_arx & has_journal
    elif f.journal_status == "Preprint Only":
        mask &= is_arx & ~has_journal

    # Paper filter (:216-227): arXiv id substring of link OR title substring
    ids = {i.lower() for i in f.paper_filter.get("ids", set())}
    titles = {t.casefold() for t in f.paper_filter.get("titles", set())}
    if ids or titles:
        pf_mask = np.zeros(n, dtype=bool)
        if ids:
            links = [(l or "").lower() for l in meta.link]
            pf_mask |= np.array([any(i in l for i in ids) for l in links])
        if titles:
            t_low = [(t or "").casefold() for t in meta.paper_title]
            pf_mask |= np.array([any(x in t for x in titles) for t in t_low])
        mask &= pf_mask

    # Result type (:230-232): lower(name) ILIKE ANY %type%
    if f.types:
        want = [t.lower() for t in f.types]
        names = [(nm or "").lower() for nm in meta.theorem_name]
        mask &= np.array([any(w in nm for w in want) for nm in names])

    # Citations (:235-243)
    if f.citation_range is not None:
        low, high = f.citation_range
        known = meta.citations >= 0
        in_range = (meta.citations >= low) & (meta.citations <= high)
        if f.include_unknown_citations:
            mask &= np.where(known, in_range, True)
        else:
            mask &= known & in_range

    if mask.all():
        # non-default filters that exclude nothing (e.g. a year range
        # covering the corpus): take the unfiltered fast path
        return None
    return mask


def filter_key(f: SearchFilters | None) -> tuple:
    """Hashable signature of a filter set: batching/caching key for the
    scheduler's per-filter groups and the engine's device-mask cache.
    () = unfiltered."""
    if f is None or f.is_default:
        return ()
    return (
        tuple(sorted(f.sources)),
        tuple(sorted(f.authors)),
        tuple(sorted(f.tags)),
        f.year_range,
        f.journal_status,
        tuple(sorted(f.paper_filter.get("ids", ()))),
        tuple(sorted(f.paper_filter.get("titles", ()))),
        tuple(sorted(f.types)),
        f.citation_range,
        f.include_unknown_citations,
    )
