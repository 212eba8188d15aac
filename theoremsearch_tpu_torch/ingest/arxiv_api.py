# Verbatim copy of theoremsearch_tpu/ingest/arxiv_api.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""arXiv metadata acquisition.

Capability-parity with the reference's ingest stage (ec2/upsert_arxiv/):
- all 32 arXiv math categories (__main__.py:12);
- queries partitioned by submittedDate windows (year/month/week/day) to
  evade the API's result cap (arxiv_papers.py:10-39);
- ThreadPool fan-out for catalog upserts with per-paper citation lookup.

Network access is injected: callers pass a `fetch(url, params) -> dict`
(tests pass fakes; production wires requests/arxiv). In zero-egress
environments everything degrades to explicit errors, never silent hangs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Callable, Iterator, Sequence

from .catalog import Catalog

# the 32 arXiv math categories (reference ec2/upsert_arxiv/__main__.py:12)
MATH_CATEGORIES = [
    "math.AC", "math.AG", "math.AP", "math.AT", "math.CA", "math.CO",
    "math.CT", "math.CV", "math.DG", "math.DS", "math.FA", "math.GM",
    "math.GN", "math.GR", "math.GT", "math.HO", "math.IT", "math.KT",
    "math.LO", "math.MG", "math.MP", "math.NA", "math.NT", "math.OA",
    "math.OC", "math.PR", "math.QA", "math.RA", "math.RT", "math.SG",
    "math.SP", "math.ST",
]


def date_partitions(
    granularity: str,
    start: datetime,
    end: datetime,
) -> Iterator[tuple[str, str]]:
    """[start, end) windows formatted as arXiv submittedDate bounds.

    Calendar-aligned for year/month, rolling for week/day (reference
    arxiv_papers.py:10-39 semantics)."""
    fmt = "%Y%m%d%H%M%S"
    cur = start
    while cur < end:
        if granularity == "year":
            nxt = datetime(cur.year + 1, 1, 1)
        elif granularity == "month":
            nxt = datetime(cur.year + (cur.month == 12), cur.month % 12 + 1, 1)
        elif granularity == "week":
            nxt = cur + timedelta(days=7)
        elif granularity == "day":
            nxt = cur + timedelta(days=1)
        else:
            raise ValueError(f"unsupported partition {granularity!r}")
        yield cur.strftime(fmt), nxt.strftime(fmt)
        cur = nxt


@dataclass
class ArxivPaper:
    paper_id: str
    title: str
    authors: list[str]
    summary: str
    link: str
    last_updated: str
    journal_ref: str | None
    primary_category: str
    categories: list[str] = field(default_factory=list)

    def to_row(self, citations: int | None = None) -> dict:
        return {
            "paper_id": self.paper_id,
            "title": self.title,
            "authors": self.authors,
            "summary": self.summary,
            "link": self.link,
            "last_updated": self.last_updated,
            "journal_ref": self.journal_ref,
            "primary_category": self.primary_category,
            "categories": self.categories,
            "citations": citations,
        }


def iter_arxiv_papers(
    query: str,
    date_partition: str = "month",
    start: datetime | None = None,
    end: datetime | None = None,
    client=None,
) -> Iterator[ArxivPaper]:
    """Yield papers for `query` across date windows. `client` is an
    arxiv.Client (constructed lazily when omitted — requires network)."""
    if client is None:
        import arxiv  # gated import

        client = arxiv.Client(page_size=500, delay_seconds=3)
    import arxiv

    start = start or datetime(1992, 1, 1)
    end = end or datetime.now()
    for w0, w1 in date_partitions(date_partition, start, end):
        search = arxiv.Search(query=f"submittedDate:[{w0} TO {w1}] AND {query}")
        for res in client.results(search):
            yield ArxivPaper(
                paper_id=res.get_short_id(),
                title=res.title,
                authors=[a.name for a in res.authors],
                summary=res.summary,
                link=res.entry_id,
                last_updated=str(res.updated),
                journal_ref=res.journal_ref,
                primary_category=res.primary_category,
                categories=list(res.categories),
            )


def upsert_arxiv(
    catalog: Catalog,
    categories: Sequence[str] = MATH_CATEGORIES,
    date_partition: str = "month",
    citation_lookup: Callable[[str, str], int | None] | None = None,
    paper_source: Callable[[str], Iterator[ArxivPaper]] | None = None,
    workers: int = 16,
) -> int:
    """Crawl categories -> upsert paper rows (with citations when a lookup
    is provided). paper_source overrides the network client in tests.
    Returns number of papers upserted."""
    count = 0
    for cat in categories:
        papers = (
            paper_source(cat)
            if paper_source is not None
            else iter_arxiv_papers(f"cat:{cat}", date_partition)
        )
        batch: list[ArxivPaper] = []
        for p in papers:
            batch.append(p)
            if len(batch) >= 16:
                count += _upsert_batch(catalog, batch, citation_lookup, workers)
                batch = []
        count += _upsert_batch(catalog, batch, citation_lookup, workers)
    return count


def _upsert_batch(catalog, batch, citation_lookup, workers) -> int:
    if not batch:
        return 0
    cites: dict[str, int | None] = {}
    if citation_lookup is not None:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for p, c in zip(batch, ex.map(lambda p: citation_lookup(p.paper_id, p.title), batch)):
                cites[p.paper_id] = c
    rows = [p.to_row(cites.get(p.paper_id)) for p in batch]
    catalog.upsert_rows("paper", rows, ["paper_id"])
    return len(rows)
