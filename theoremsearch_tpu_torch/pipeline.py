"""End-to-end pipeline glue: catalog -> encoder -> index -> engine (port
of theoremsearch_tpu/pipeline.py).

Pages the latest slogans missing vectors for an embedder, encodes them
batched, spools them into the resumable IndexBuilder and records the
embedding manifest (the catalog commit is the checkpoint); packs the
spool into a SearchEngine with the catalog's metadata joined; and keeps
a running engine fresh as new slogans arrive.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
import torch

from .core.config import IndexConfig
from .index.builder import IndexBuilder
from .index.flat import PAD_ID, FlatIndex
from .ingest.catalog import Catalog
from .search.engine import SearchEngine
from .search.metadata import CorpusMetadata
from .utils.shapes import round_up


def embed_missing_slogans(
    catalog: Catalog,
    encode_fn: Callable[[list[str]], np.ndarray],
    builder: IndexBuilder,
    embedder: str = "qwen",
    page_size: int = 256,
    limit: int | None = None,
) -> int:
    """Encode every latest-slogan lacking a vector; returns rows embedded."""
    done = 0
    for page in catalog.slogans_missing_embedding(embedder, page_size):
        rows = [dict(r) for r in page]
        if limit is not None:
            rows = rows[: max(0, limit - done)]
            if not rows:
                break
        texts = [r["slogan"] or "" for r in rows]
        ids = np.array([r["slogan_id"] for r in rows], np.int64)
        emb = np.asarray(encode_fn(texts), np.float32)
        builder.add(ids, emb)
        catalog.upsert_rows(
            "embedding_manifest",
            [{"embedder": embedder, "slogan_id": int(sid), "shard": builder.dir.name, "row": -1}
             for sid in ids],
            ["embedder", "slogan_id"],
        )
        done += len(rows)
        if limit is not None and done >= limit:
            break
    return done


def corpus_metadata_from_catalog(catalog: Catalog, slogan_ids: np.ndarray) -> CorpusMetadata:
    """Join paper+theorem+slogan rows for the indexed slogan ids, in index
    order (the metadata side of the reference's latest-slogan join)."""
    return CorpusMetadata.from_rows(slogan_meta_rows(catalog, slogan_ids))


def slogan_meta_rows(catalog: Catalog, slogan_ids: np.ndarray) -> list[dict]:
    """Metadata column dicts for slogan ids (shared by the index-build
    join and the live refresh), one batched IN-query per 500 ids."""
    sids = [int(s) for s in np.asarray(slogan_ids).tolist()]
    by_sid: dict[int, tuple] = {}
    for start in range(0, len(sids), 500):
        chunk = sids[start : start + 500]
        marks = ",".join("?" * len(chunk))
        for r in catalog.conn.execute(
            "SELECT s.slogan_id, p.paper_id, p.title, p.authors, p.link,"
            " p.last_updated, p.journal_ref, p.primary_category, p.citations,"
            " p.summary, t.name, t.body, s.slogan"
            " FROM theorem_slogan s"
            " JOIN theorem t ON t.theorem_id = s.theorem_id"
            " JOIN paper p ON p.paper_id = t.paper_id"
            f" WHERE s.slogan_id IN ({marks})",
            chunk,
        ):
            by_sid[int(r[0])] = tuple(r[1:])
    rows = []
    for sid in sids:
        r = by_sid.get(sid)
        if r is None:
            rows.append({})
            continue
        year = 0
        if r[4]:
            try:
                year = int(str(r[4])[:4])
            except ValueError:
                year = 0
        rows.append({
            "paper_id": r[0],
            "paper_title": r[1] or "",
            "authors": json.loads(r[2]) if r[2] else [],
            "link": r[3] or "",
            "year": year,
            "primary_category": r[6] or "",
            "journal_ref": r[5],
            "citations": r[7],
            "summary": r[8] or "",
            "theorem_name": r[9] or "",
            "theorem_body": r[10] or "",
            "slogan": r[11] or "",
        })
    return rows


def refresh_engine_from_catalog(
    catalog: Catalog,
    engine: SearchEngine,
    encode_fn: Callable[[list[str]], np.ndarray],
    embedder: str = "qwen",
    page_size: int = 256,
    builder: IndexBuilder | None = None,
) -> int:
    """Live refresh of a running engine: embed every latest-slogan that
    has no vector yet and add it to the engine's delta buffer, searchable
    by the next query. Idempotent through the embedding_manifest
    NOT-EXISTS queue; returns docs added.

    builder: the spool the engine was built from. Required for
    durability: the manifest marks these slogans embedded, so without
    spooling their vectors a restart would rebuild the index without
    them and the queue would never retry them. Pass None only for a
    throwaway in-memory engine."""
    added = 0
    shard = builder.dir.name if builder is not None else "live-delta"
    live_by_theorem: dict[tuple, int] | None = None
    for page in catalog.slogans_missing_embedding(embedder, page_size):
        rows = [dict(r) for r in page]
        texts = [r["slogan"] or "" for r in rows]
        sids = np.array([r["slogan_id"] for r in rows], np.int64)
        emb = np.asarray(encode_fn(texts), np.float32)
        meta_rows = slogan_meta_rows(catalog, sids) if engine.meta is not None else None
        if builder is not None:
            # the crash-safety order: spool (durable) -> manifest (marks
            # embedded) -> live add. A crash after the manifest loses only
            # live visibility until restart (the rebuild packs the spooled
            # vector); the reverse order re-added live docs on every poll.
            builder.add(sids, emb)
        catalog.upsert_rows(
            "embedding_manifest",
            [{"embedder": embedder, "slogan_id": int(sid), "shard": shard, "row": -1}
             for sid in sids],
            ["embedder", "slogan_id"],
        )
        if meta_rows is not None:
            # a new latest slogan supersedes the theorem's current doc (the
            # reference serves the latest slogan per theorem): tombstone it,
            # so search serves one doc per theorem. Theorem identity is
            # (paper_id, name), unique in the schema.
            if live_by_theorem is None:
                m = engine.meta
                live_by_theorem = {(m.paper_id[d], m.theorem_name[d]): d for d in range(len(m))}
            stale = []
            for mr in meta_rows:
                old = live_by_theorem.get((mr.get("paper_id"), mr.get("theorem_name")))
                if old is not None:
                    stale.append(old)
            if stale:
                engine.delete_documents(stale)
            new_ids = engine.add_documents(emb, meta_rows=meta_rows)
            for mr, d in zip(meta_rows, new_ids):
                live_by_theorem[(mr.get("paper_id"), mr.get("theorem_name"))] = int(d)
        else:
            engine.add_documents(emb, meta_rows=meta_rows)
        added += len(rows)
    return added


def _latest_rows_index(index: FlatIndex, sel: torch.Tensor) -> FlatIndex:
    """The packed rows `sel` of `index`, in that order, with row-order
    doc ids (arange) and the index's global scale kept: both keep the
    speed path and the residual rescore eligible (remapping ids in place
    would force the id -> row indirection on every rescore, and dropping
    global_scale would turn the speed path into the exact route)."""
    n = int(sel.shape[0])
    padded = round_up(max(n, 1), index.config.pad_multiple)
    vecs = torch.zeros((padded, index.dim), dtype=index.vectors.dtype)
    vecs[:n] = index.vectors[sel]
    ids = torch.full((padded,), PAD_ID, dtype=index.ids.dtype)
    ids[:n] = torch.arange(n, dtype=index.ids.dtype)
    scales = None
    if index.scales is not None:
        scales = torch.zeros(padded, dtype=torch.float32)
        scales[:n] = index.scales[sel]
    resid = index.rescore_residual
    if resid is not None:
        resid = (resid[0][sel], resid[1][sel])
    return FlatIndex(vectors=vecs, ids=ids, scales=scales, num_rows=n, config=index.config,
                     global_scale=index.global_scale, rescore_residual=resid)


def build_engine_from_catalog(
    catalog: Catalog,
    encode_fn: Callable[[list[str]], np.ndarray],
    spool_dir: str,
    embedder: str = "qwen",
    index_config: IndexConfig | None = None,
    mesh=None,
    device=None,
) -> SearchEngine:
    """One-call path: embed whatever is missing, pack the index on
    `device` (default: the card, or the mesh's first device), join the
    metadata, return a ready SearchEngine on the same device, row-sharded
    over `mesh` when one is given."""
    if mesh is not None and device is None:
        device = mesh.first_device
    builder = IndexBuilder(spool_dir, index_config)
    embed_missing_slogans(catalog, encode_fn, builder, embedder)
    index = builder.finalize(device=device)
    latest = {int(r[0]) for r in catalog.conn.execute(
        "SELECT MAX(slogan_id) FROM theorem_slogan GROUP BY theorem_id")}
    # self-heal a manifest/spool divergence: a slogan marked embedded
    # whose vector never reached this spool (a refresh without the
    # durable builder, or another spool dir) would never be retried by
    # the NOT-EXISTS queue, and the rebuild would silently shrink
    spooled = set(index.ids[: index.num_rows].tolist())
    missing = sorted(latest - spooled)
    if missing:
        texts: list[str] = []
        for start in range(0, len(missing), 500):
            chunk = missing[start : start + 500]
            marks = ",".join("?" * len(chunk))
            got = dict(catalog.conn.execute(
                f"SELECT slogan_id, slogan FROM theorem_slogan WHERE slogan_id IN ({marks})",
                chunk))
            texts.extend([got.get(i) or "" for i in chunk])
        builder.add(np.array(missing, np.int64), np.asarray(encode_fn(texts), np.float32))
        index = builder.finalize(device=device)
    # the spool is append-only: a theorem whose slogan was regenerated
    # still has its superseded slogan packed. Keep only the ids that are
    # still the latest for their theorem, in sorted doc-id order (the
    # metadata's order), or search returns several docs per theorem.
    real_ids = index.ids[: index.num_rows].numpy()
    keep = np.fromiter((int(i) in latest for i in real_ids), bool, count=real_ids.shape[0])
    kept_ids = real_ids[keep]
    meta = corpus_metadata_from_catalog(catalog, np.sort(kept_ids))
    sel = torch.from_numpy(np.flatnonzero(keep)[np.argsort(kept_ids, kind="stable")])
    return SearchEngine(_latest_rows_index(index, sel), meta=meta, device=device, mesh=mesh)
