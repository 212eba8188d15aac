"""The serving corpus's metadata, in the layout of the kernel smoke's
`bench_metadata` (years in contiguous id blocks, categories striped,
journal status alternating, citations i % 1000), frozen here; the rows
that carry slogans are given, not the first ones. `MIX36` is the
36-signature filter mix of the filtered serving traffic, for a later
cell."""

from __future__ import annotations

import numpy as np

CATS = [f"math.{c}" for c in
        "AG AT AP CA CO CT DG DS FA GM GN GR GT HO KT LO MG NT OA PR RA RT".split()]
MIX36 = ([{"year_range": [1996 + j, 2001 + j]} for j in range(16)]
         + [{"tags": [f"math.{c}"]} for c in ("AG", "NT", "CO", "PR", "CA", "DG", "FA", "GT")]
         + [{"citation_range": [50 * j, 50 * j + 120]} for j in range(8)]
         + [{"year_range": [2004, 2015], "tags": ["math.AG", "math.NT"]},
            {"journal_status": "Journal Article", "citation_range": [10, 500]},
            {"year_range": [2010, 2020], "journal_status": "Preprint Only"},
            {"tags": ["math.CO"], "citation_range": [0, 99]}])


def columns(n: int, rows, texts: list[str]) -> dict:
    """Column dicts of n rows; row rows[j] carries texts[j]."""
    rows = np.asarray(rows, np.int64)
    title = ["T"] * n
    link = ["https://arxiv.org/abs/x"] * n
    name = [""] * n
    slogan = [""] * n
    body = [""] * n
    for r, t in zip(rows.tolist(), texts):
        title[r] = f"Paper {r}"
        link[r] = f"https://arxiv.org/abs/2401.{r:07d}"
        name[r] = "Theorem"
        slogan[r] = t
        body[r] = f"$x_{{{r}}}$ is bounded."
    return dict(
        paper_id=[f"p{i}" for i in range(n)], paper_title=title, authors=[[] for _ in range(n)],
        link=link, year=(1995 + np.arange(n) // max(1, n // 30)).astype(np.int32),
        primary_category=[CATS[i % len(CATS)] for i in range(n)],
        journal_ref=[None, "J. Math."] * (n // 2) + [None] * (n % 2),
        citations=np.arange(n, dtype=np.int64) % 1000,
        theorem_name=name, slogan=slogan, theorem_body=body)


def expected_row(n: int, d: int, slogan_of: dict) -> dict:
    """The fields a served result for doc id d must carry (the metadata
    join of that row), by the layout above."""
    text = slogan_of.get(d)
    year = int(1995 + d // max(1, n // 30))
    return {
        "doc_id": d, "paper_id": f"p{d}",
        "paper_title": f"Paper {d}" if text is not None else "T",
        "paper_url": f"https://arxiv.org/abs/2401.{d:07d}" if text is not None
        else "https://arxiv.org/abs/x",
        "year": year or None, "primary_category": CATS[d % len(CATS)],
        "journal_published": d % 2 == 1, "citations": d % 1000,
        "theorem_name": "Theorem" if text is not None else "",
        "theorem_slogan": text if text is not None else "",
    }
