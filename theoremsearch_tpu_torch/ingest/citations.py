# Verbatim copy of theoremsearch_tpu/ingest/citations.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Citation-count lookup with a 3-step fallback chain.

Parity with the reference (ec2/upsert_arxiv/citations.py:8-62):
1. OpenAlex by arXiv DOI;
2. Semantic Scholar by arXiv id;
3. Semantic Scholar title search with an exact (case-folded) title check.
Returns None when every step fails. The HTTP getter is injectable for
tests / offline runs.
"""

from __future__ import annotations

from typing import Callable

Fetch = Callable[[str, dict], "dict | None"]


def _default_fetch(url: str, params: dict) -> dict | None:
    import requests  # gated import

    try:
        res = requests.get(url, params=params or None, timeout=10)
        if res.ok:
            return res.json()
    except Exception:
        return None
    return None


def get_paper_citations(
    paper_id: str,
    title: str | None = None,
    fetch: Fetch | None = None,
) -> int | None:
    fetch = fetch or _default_fetch
    from .sources import normalize_arxiv_id

    # NOT split('v'): archives like 'solv-int/9901001' contain 'v'
    base_id = normalize_arxiv_id(paper_id)

    data = fetch(f"https://api.openalex.org/works/doi:10.48550/arXiv.{base_id}", {})
    if data is not None:
        k = data.get("cited_by_count")
        if isinstance(k, int):
            return k

    data = fetch(
        f"https://api.semanticscholar.org/graph/v1/paper/arXiv:{base_id}",
        {"fields": "citationCount"},
    )
    if data is not None:
        k = data.get("citationCount")
        if isinstance(k, int):
            return k

    if title:
        data = fetch(
            "https://api.semanticscholar.org/graph/v1/paper/search",
            {"query": title, "limit": 1, "fields": "title,citationCount"},
        )
        if data is not None:
            items = data.get("data") or []
            if items and items[0].get("title", "").strip().lower() == title.strip().lower():
                k = items[0].get("citationCount")
                if isinstance(k, int):
                    return k

    return None
