# Verbatim copy of theoremsearch_tpu/search/metadata.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Host-side corpus metadata — the filterable/displayable attributes that
the reference keeps in the `paper` + `theorem` Postgres tables
(rds_schema.sql:1-31) and joins at query time (streamlit_app.py:276-279).

Here they live as columnar numpy arrays / lists aligned with index doc
ids, so filter compilation is a handful of vectorized ops over 1M rows
instead of a SQL WHERE, and the top-k -> result join is O(k) list
indexing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import numpy as np

# Single source of truth for the column names: extend/update_row/
# row_as_dict/save all iterate these, so adding a column means editing
# the dataclass and these tuples only — not four hand-written lists
# that would silently skip it.
_LIST_COLUMNS = (
    "paper_id", "paper_title", "authors", "link", "primary_category",
    "journal_ref", "summary", "theorem_name", "theorem_body", "slogan",
)
_NUM_COLUMNS = ("year", "citations")


@dataclass
class CorpusMetadata:
    """Column store aligned with doc ids 0..N-1."""

    # paper-level
    paper_id: list[str]
    paper_title: list[str]
    authors: list[list[str]]
    link: list[str]
    year: np.ndarray                 # int32, 0 = unknown
    primary_category: list[str]
    journal_ref: list[str | None]
    citations: np.ndarray            # int64, -1 = unknown (NULL)
    summary: list[str] = field(default_factory=list)
    # theorem-level
    theorem_name: list[str] = field(default_factory=list)
    theorem_body: list[str] = field(default_factory=list)
    slogan: list[str] = field(default_factory=list)

    def __post_init__(self):
        n = len(self.paper_id)
        self.year = np.asarray(self.year, dtype=np.int32)
        self.citations = np.asarray(self.citations, dtype=np.int64)
        for name in ("paper_title", "authors", "link", "primary_category", "journal_ref"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"column {name} length != {n}")
        for name in ("summary", "theorem_name", "theorem_body", "slogan"):
            col = getattr(self, name)
            if not col:
                setattr(self, name, [""] * n)
            elif len(col) != n:
                raise ValueError(f"column {name} length != {n}")

    def __len__(self) -> int:
        return len(self.paper_id)

    @property
    def is_arxiv(self) -> np.ndarray:
        """Source discriminator — the reference uses link ILIKE '%arxiv.org%'
        (streamlit_app.py:180-186)."""
        return np.array(["arxiv.org" in (l or "").lower() for l in self.link])

    # ---------------- facets (streamlit_app.py:70-116) ----------------

    def load_authors(self) -> list[str]:
        """Distinct sorted author facet."""
        out: set[str] = set()
        for a in self.authors:
            out.update(x for x in (a or []) if x)
        return sorted(out)

    def load_tags_per_source(self) -> dict[str, list[str]]:
        tags: dict[str, set[str]] = {}
        arx = self.is_arxiv
        for i, cat in enumerate(self.primary_category):
            if not cat:
                continue
            src = "arXiv" if arx[i] else "Stacks Project"
            tags.setdefault(src, set()).add(cat)
        return {src: sorted(cats) for src, cats in tags.items()}

    def theorem_count(self) -> int:
        return len(self)

    # ---------------- live updates ----------------

    def extend(self, rows: Sequence[dict[str, Any]]) -> None:
        """Append docs (live-update path): doc ids len(self)..len(self)+m-1.
        Same row spec as from_rows."""
        add = CorpusMetadata.from_rows(rows)
        for name in _LIST_COLUMNS:
            getattr(self, name).extend(getattr(add, name))
        for name in _NUM_COLUMNS:
            setattr(
                self, name, np.concatenate([getattr(self, name), getattr(add, name)])
            )

    def update_row(self, doc_id: int, row: dict[str, Any]) -> None:
        """Overwrite one doc's columns in place (live upsert of an
        existing doc id). Keys absent from `row` keep their value."""
        one = CorpusMetadata.from_rows([row])
        for name in _LIST_COLUMNS:
            if name in row:
                getattr(self, name)[doc_id] = getattr(one, name)[0]
        for name in _NUM_COLUMNS:
            if name in row:
                getattr(self, name)[doc_id] = getattr(one, name)[0]

    def row_as_dict(self, doc_id: int) -> dict[str, Any]:
        out = {name: getattr(self, name)[doc_id] for name in _LIST_COLUMNS}
        out.update({name: int(getattr(self, name)[doc_id]) for name in _NUM_COLUMNS})
        return out

    # ---------------- persistence ----------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path / "meta_num.npz",
            **{name: getattr(self, name) for name in _NUM_COLUMNS},
        )
        cols = {name: getattr(self, name) for name in _LIST_COLUMNS}
        with open(path / "meta_str.json", "w", encoding="utf-8") as f:
            json.dump(cols, f)

    @classmethod
    def load(cls, path: str | Path) -> "CorpusMetadata":
        path = Path(path)
        num = np.load(path / "meta_num.npz")
        with open(path / "meta_str.json", encoding="utf-8") as f:
            cols = json.load(f)
        return cls(**{name: num[name] for name in _NUM_COLUMNS}, **cols)

    # ---------------- builders ----------------

    @classmethod
    def from_rows(cls, rows: Sequence[dict[str, Any]]) -> "CorpusMetadata":
        """rows: one dict per doc with the column names as keys."""
        def col(name, default):
            return [r.get(name, default) for r in rows]

        return cls(
            paper_id=col("paper_id", ""),
            paper_title=col("paper_title", ""),
            authors=col("authors", []),
            link=col("link", ""),
            year=np.array([r.get("year") or 0 for r in rows], np.int32),
            primary_category=col("primary_category", ""),
            journal_ref=col("journal_ref", None),
            citations=np.array(
                [r["citations"] if r.get("citations") is not None else -1 for r in rows],
                np.int64,
            ),
            summary=col("summary", ""),
            theorem_name=col("theorem_name", ""),
            theorem_body=col("theorem_body", ""),
            slogan=col("slogan", ""),
        )
