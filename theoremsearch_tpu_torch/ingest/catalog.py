# Verbatim copy of theoremsearch_tpu/ingest/catalog.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Local catalog: the coordination plane.

Replaces the reference's RDS substrate (SURVEY.md component 1-2):
- schema parity with rds_schema.sql:1-57 (paper, paper_arxiv_s3_location,
  theorem, theorem_slogan, per-model embedding manifests) on SQLite;
- generic idempotent upsert (INSERT ... ON CONFLICT DO UPDATE), the
  equivalent of ec2/rds/upsert.py:29-52;
- keyset pagination over any query (ec2/rds/paginate.py:5-68 semantics:
  ORDER BY key, resume WHERE key > last, fixed page size);
- conditional query builder with optional random sampling
  (ec2/rds/query.py:9-56).

The DB remains the checkpoint: every ingest stage selects only missing
work (NOT EXISTS) and commits per page, so any stage is crash-resumable
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import json
import sqlite3
from pathlib import Path
from typing import Any, Iterator, Sequence

SCHEMA = """
CREATE TABLE IF NOT EXISTS paper (
    paper_id TEXT PRIMARY KEY,
    title TEXT,
    authors TEXT,              -- JSON list
    summary TEXT,
    link TEXT,
    last_updated TEXT,
    journal_ref TEXT,
    primary_category TEXT,
    categories TEXT,           -- JSON list
    citations INTEGER
);
CREATE TABLE IF NOT EXISTS paper_arxiv_s3_location (
    paper_id TEXT PRIMARY KEY REFERENCES paper(paper_id),
    bundle_tar TEXT,
    offset_start INTEGER,
    offset_end INTEGER
);
CREATE TABLE IF NOT EXISTS theorem (
    theorem_id INTEGER PRIMARY KEY AUTOINCREMENT,
    paper_id TEXT REFERENCES paper(paper_id),
    name TEXT,
    body TEXT,
    label TEXT,
    parsing_method TEXT,
    UNIQUE(paper_id, name)
);
CREATE TABLE IF NOT EXISTS theorem_slogan (
    slogan_id INTEGER PRIMARY KEY AUTOINCREMENT,
    theorem_id INTEGER REFERENCES theorem(theorem_id),
    model TEXT,
    prompt_id TEXT,
    slogan TEXT,
    UNIQUE(theorem_id, model, prompt_id)
);
CREATE TABLE IF NOT EXISTS parse_status (
    paper_id TEXT PRIMARY KEY REFERENCES paper(paper_id),
    status TEXT,               -- ok | err | timeout
    theorems INTEGER,
    parsed_at REAL
);
CREATE TABLE IF NOT EXISTS embedding_manifest (
    embedder TEXT,
    slogan_id INTEGER REFERENCES theorem_slogan(slogan_id),
    shard TEXT,                -- index shard file holding the vector
    row INTEGER,               -- row within the shard
    UNIQUE(embedder, slogan_id)
);
CREATE INDEX IF NOT EXISTS idx_theorem_paper ON theorem(paper_id);
CREATE INDEX IF NOT EXISTS idx_slogan_theorem ON theorem_slogan(theorem_id);
"""


class Catalog:
    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        self.conn = sqlite3.connect(self.path)
        self.conn.row_factory = sqlite3.Row
        self.conn.executescript(SCHEMA)
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    # ------------------------------------------------------------------
    # generic upsert (ec2/rds/upsert.py semantics)
    # ------------------------------------------------------------------

    def upsert_row(self, table: str, row: dict[str, Any], conflict_cols: Sequence[str]) -> None:
        self.upsert_rows(table, [row], conflict_cols)

    def upsert_rows(
        self, table: str, rows: Sequence[dict[str, Any]], conflict_cols: Sequence[str]
    ) -> None:
        if not rows:
            return
        cols = list(rows[0].keys())
        placeholders = ",".join("?" for _ in cols)
        updates = ",".join(f"{c}=excluded.{c}" for c in cols if c not in conflict_cols)
        sql = (
            f"INSERT INTO {table} ({','.join(cols)}) VALUES ({placeholders}) "
            f"ON CONFLICT({','.join(conflict_cols)}) DO UPDATE SET {updates}"
        )
        vals = [tuple(_encode(r[c]) for c in cols) for r in rows]
        self.conn.executemany(sql, vals)
        self.conn.commit()

    # ------------------------------------------------------------------
    # keyset pagination (ec2/rds/paginate.py semantics)
    # ------------------------------------------------------------------

    def paginate(
        self,
        sql: str,
        order_col: str,
        page_size: int = 1000,
        params: Sequence[Any] = (),
        start_after: Any = None,
    ) -> Iterator[list[sqlite3.Row]]:
        """Page `sql` (which must expose order_col in its SELECT) by
        keyset: each page appends 'AND order_col > last' and re-orders."""
        last = start_after
        has_where = " where " in sql.lower()
        while True:
            q = sql
            p = list(params)
            if last is not None:
                q += f" {'AND' if has_where else 'WHERE'} {order_col} > ?"
                p.append(last)
            q += f" ORDER BY {order_col} LIMIT {int(page_size)}"
            rows = self.conn.execute(q, p).fetchall()
            if not rows:
                return
            yield rows
            last = rows[-1][order_col.split(".")[-1]]

    # ------------------------------------------------------------------
    # conditional query builder (ec2/rds/query.py semantics)
    # ------------------------------------------------------------------

    def build_query(
        self,
        table: str,
        columns: Sequence[str] = ("*",),
        conditions: Sequence[str] = (),
        random_sample: int | None = None,
    ) -> str:
        q = f"SELECT {', '.join(columns)} FROM {table}"
        if conditions:
            q += " WHERE " + " AND ".join(conditions)
        if random_sample:
            q += f" ORDER BY RANDOM() LIMIT {int(random_sample)}"
        return q

    def count(self, table: str, conditions: Sequence[str] = (), params: Sequence[Any] = ()) -> int:
        q = f"SELECT COUNT(*) FROM {table}"
        if conditions:
            q += " WHERE " + " AND ".join(conditions)
        return self.conn.execute(q, params).fetchone()[0]

    # ------------------------------------------------------------------
    # domain helpers
    # ------------------------------------------------------------------

    def upsert_paper(self, paper: dict[str, Any]) -> None:
        self.upsert_row("paper", paper, ["paper_id"])

    def replace_theorems(
        self, paper_id: str, theorems: Sequence[dict[str, Any]], parsing_method: str
    ) -> None:
        """Delete-then-insert per paper, the reference's re-parse semantics
        (ec2/parse_arxiv_papers/__main__.py:269-285)."""
        import time as _time

        self.conn.execute("DELETE FROM theorem WHERE paper_id = ?", (paper_id,))
        seen: dict[str, int] = {}
        for t in theorems:
            name = t["name"]
            # duplicated headings (several `\newtheorem*` envs all render
            # as bare 'Remark') get a disambiguating suffix instead of
            # being silently dropped by UNIQUE(paper_id, name)
            if name in seen:
                seen[name] += 1
                name = f"{name} ({seen[name]})"
            else:
                seen[name] = 1
            self.conn.execute(
                "INSERT OR IGNORE INTO theorem (paper_id, name, body, label, parsing_method)"
                " VALUES (?,?,?,?,?)",
                (paper_id, name, t.get("body", ""), t.get("label"), parsing_method),
            )
        # record the parse OUTCOME: a paper that parsed fine with zero
        # theorems (PDF-only source) must leave the work queue, or every
        # run re-pays its S3 fetch forever
        self.conn.execute(
            "INSERT OR REPLACE INTO parse_status (paper_id, status, theorems, parsed_at)"
            " VALUES (?,?,?,?)",
            (paper_id, "ok", len(theorems), _time.time()),
        )
        self.conn.commit()

    def record_parse_failure(self, paper_id: str, status: str) -> None:
        """err/timeout outcomes stay IN the queue (retryable) but are
        visible for diagnostics."""
        import time as _time

        self.conn.execute(
            "INSERT OR REPLACE INTO parse_status (paper_id, status, theorems, parsed_at)"
            " VALUES (?,?,?,?)",
            (paper_id, status, 0, _time.time()),
        )
        self.conn.commit()

    def unparsed_papers(self, page_size: int = 100) -> Iterator[list[sqlite3.Row]]:
        """Papers with an S3 location but no theorems — the NOT EXISTS work
        queue (ec2/parse_arxiv_papers/__main__.py:153-178)."""
        sql = (
            "SELECT p.paper_id AS paper_id FROM paper p "
            "WHERE NOT EXISTS (SELECT 1 FROM theorem t WHERE t.paper_id = p.paper_id) "
            "AND NOT EXISTS (SELECT 1 FROM parse_status ps "
            "  WHERE ps.paper_id = p.paper_id AND ps.status = 'ok')"
        )
        return self.paginate(sql, "paper_id", page_size)

    def theorems_missing_slogan(self, model: str, prompt_id: str, page_size: int = 1000):
        sql = (
            "SELECT t.theorem_id AS theorem_id, t.name AS name, t.body AS body, t.paper_id AS paper_id "
            "FROM theorem t WHERE NOT EXISTS ("
            "  SELECT 1 FROM theorem_slogan s WHERE s.theorem_id = t.theorem_id"
            "  AND s.model = ? AND s.prompt_id = ?)"
        )
        return self.paginate(sql, "theorem_id", page_size, params=(model, prompt_id))

    def slogans_missing_embedding(self, embedder: str, page_size: int = 1000):
        """Latest slogan per theorem lacking a vector for this embedder —
        combines the reference's missing-embedding NOT EXISTS
        (generate_embeddings/__main__.py:22-56) with the latest-slogan
        DISTINCT ON selection (streamlit_app.py:254-259)."""
        sql = (
            "SELECT s.slogan_id AS slogan_id, s.theorem_id AS theorem_id, s.slogan AS slogan "
            "FROM theorem_slogan s "
            "WHERE s.slogan_id = (SELECT MAX(s2.slogan_id) FROM theorem_slogan s2"
            "                     WHERE s2.theorem_id = s.theorem_id) "
            "AND NOT EXISTS (SELECT 1 FROM embedding_manifest e"
            "                WHERE e.embedder = ? AND e.slogan_id = s.slogan_id)"
        )
        return self.paginate(sql, "slogan_id", page_size, params=(embedder,))


def _encode(v: Any) -> Any:
    if isinstance(v, (list, dict)):
        return json.dumps(v)
    return v
