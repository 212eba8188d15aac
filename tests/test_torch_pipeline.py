"""Port parity: the catalog -> encoder -> index -> engine pipeline
(theoremsearch_tpu_torch/pipeline.py) against the JAX package's, twins of
tests/test_pipeline_e2e.py's device paths and tests/test_live_refresh.py.

Each case is written once as a scenario over a package namespace and run
on both packages. The catalog is filled as the JAX tests fill theirs
(papers through parse_papers, slogans through generate_slogans with the
offline stub) and each package gets its own copy of the sqlite file:
both write embedding_manifest, so a shared file would empty the
NOT-EXISTS queue for the second. Both use the same deterministic numpy
encode_fn, so their index inputs are identical. The scenarios return
records that must agree: the engine's kept ids, row order (the packed
vectors) and metadata, the embedding manifest, and searches (ids equal
where scores are unique, scores within 1e-5)."""

import gzip
import shutil
import zlib

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu import pipeline as JP
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.encoder import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.encoder.model import init_params as jax_init_params
from theoremsearch_tpu.index.builder import IndexBuilder as JIndexBuilder
from theoremsearch_tpu.ingest.catalog import Catalog as JCatalog
from theoremsearch_tpu.ingest.parse_driver import parse_papers
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.serve.app import SearchService as JSearchService
from theoremsearch_tpu.slogans import OfflineStubClient, generate_slogans, load_prompt
from theoremsearch_tpu_torch import pipeline as PP
from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import params_from_jax
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.index.builder import IndexBuilder
from theoremsearch_tpu_torch.ingest import Catalog
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import _LIST_COLUMNS, _NUM_COLUMNS
from theoremsearch_tpu_torch.serve.app import SearchService

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()

TOPICS = ["prime numbers", "graph colorings", "elliptic curves", "banach spaces", "random walks"]
WORDS = ("compact normal finite smooth abelian proper flat simple bounded dense exact free "
         "graded local perfect regular").split()


def _hash_encode(texts):
    """Bag of words hashed into 128 buckets (crc32: the same in every
    process), L2-normalized."""
    out = np.zeros((len(texts), 128), np.float32)
    for i, t in enumerate(texts):
        for tok in t.lower().split():
            out[i, zlib.crc32(tok.encode()) % 128] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


def _tex(bodies):
    envs = "".join(f"\\begin{{theorem}} {b} \\end{{theorem}}\n" for b in bodies)
    return ("\\documentclass{article}\n\\newtheorem{theorem}{Theorem}[section]\n"
            f"\\begin{{document}}\\section{{Intro}}\n{envs}\\end{{document}}\n").encode()


def _add_paper(cat, sources, pid, topic, bodies, year="2024-01-01", citations=5, jref=None):
    cat.upsert_paper({
        "paper_id": pid, "title": f"A paper on {topic}", "authors": [f"Author {len(pid) % 3}"],
        "summary": f"We study {topic}.", "link": f"https://arxiv.org/abs/{pid}",
        "last_updated": year, "journal_ref": jref, "primary_category": "math.NT",
        "categories": ["math.NT"], "citations": citations,
    })
    sources[pid] = gzip.compress(_tex(bodies))


def _ingest(cat, sources, prompt="body-only-v1"):
    parse_papers(cat, source_fetcher=lambda pid: sources[pid], timeout_s=30)
    generate_slogans(cat, load_prompt(prompt), OfflineStubClient())


def _topic_papers(cat, sources, topics, prefix="2401"):
    for i, topic in enumerate(topics):
        _add_paper(cat, sources, f"{prefix}.{i:05d}", topic, [f"Every result about {topic} holds."])
    _ingest(cat, sources)


# ---------------------------------------------------------------- the twin


class Pkg:
    """One package's pipeline over its own copy of the catalog file."""

    def __init__(self, name: str, db: str):
        self.jax = name == "jax"
        self.cat = (JCatalog if self.jax else Catalog)(db)
        self.P = JP if self.jax else PP
        self.IndexBuilder = JIndexBuilder if self.jax else IndexBuilder
        self.IndexConfig = JIndexConfig if self.jax else IndexConfig
        self.SearchFilters = JSearchFilters if self.jax else SearchFilters
        self.SearchService = JSearchService if self.jax else SearchService
        self.sources: dict = {}

    def build(self, spool, encode_fn=_hash_encode, **kw):
        kw |= {"use_pallas": False} if self.jax else {"device": "cpu"}
        return self.P.build_engine_from_catalog(self.cat, encode_fn, str(spool), **kw)

    def refresh(self, engine, **kw):
        return self.P.refresh_engine_from_catalog(self.cat, engine, _hash_encode, **kw)

    def manifest(self):
        return sorted(tuple(r) for r in self.cat.conn.execute(
            "SELECT embedder, slogan_id, shard FROM embedding_manifest"))


def _np(x, dtype=np.float32):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().astype(dtype)
    return np.asarray(x).astype(dtype)


def _state(engine):
    """What the rebuild decided: kept rows in order, their ids and metadata."""
    n = engine.n_valid
    meta = engine.meta
    return {
        "n_valid": n, "num_live": engine.num_live,
        "ids": _np(engine.ids, np.int64)[:n], "vectors": _np(engine.vectors)[:n],
        "global_scale": float(engine._global_scale),
        "meta": {c: list(getattr(meta, c)) for c in _LIST_COLUMNS}
        | {c: [int(v) for v in np.asarray(getattr(meta, c))] for c in _NUM_COLUMNS},
    }


def _search(engine, q, k):
    s, i = engine.search_vectors(q, k=k)
    return "search", _np(s), _np(i, np.int64)


def _rows(rows):
    return ("search", np.array([[r["similarity"] for r in rows]], np.float32),
            np.array([[r["doc_id"] for r in rows]], np.int64))


def _assert_agree(want, got, path="record"):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            _assert_agree(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, tuple) and want and want[0] == "search":
        (_, sw, iw), (_, sg, ig) = want, got
        np.testing.assert_allclose(sg, sw, atol=1e-5, err_msg=path)
        near = np.zeros(sw.shape, bool)        # a neighbouring score within 1e-5
        gap = np.abs(np.diff(sw, axis=1)) <= 1e-5
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        assert np.array_equal(ig[~near], iw[~near]), path
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, list) and any(isinstance(w, np.ndarray) for w in want):
        assert len(want) == len(got), path
        for j, (w, g) in enumerate(zip(want, got)):
            _assert_agree(w, g, f"{path}[{j}]")
    else:
        assert got == want, path


def twin(tmp_path, setup, scenario):
    """Fill one catalog file with `setup`, give each package a copy, run
    `scenario(pkg, tmp)` on both; their records must agree."""
    base = tmp_path / "base.db"
    cat = JCatalog(str(base))
    setup(cat, {})
    cat.close()
    recs = {}
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        shutil.copy(base, tmp_path / name / "cat.db")
        pkg = Pkg(name, str(tmp_path / name / "cat.db"))
        recs[name] = scenario(pkg, tmp_path / name)
        pkg.cat.close()
    _assert_agree(recs["jax"], recs["torch"])
    return recs["torch"]


def _queries(n, seed=0, d=128):
    q = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ---------------------------------------------- tests/test_pipeline_e2e.py


def _ten_papers(cat, sources):
    for i in range(10):
        _add_paper(cat, sources, f"2401.{i:05d}", TOPICS[i % 5],
                   [f"Every result about {TOPICS[i % 5]} holds with constant {i}."],
                   year="2024-01-01", citations=10 * i, jref="J" if i % 2 else None)
    _ingest(cat, sources)
    assert cat.count("theorem_slogan") == 10


def test_full_pipeline_catalog_to_serving(tmp_path):
    def scenario(pkg, tmp):
        engine = pkg.build(tmp / "spool")
        assert engine.n_valid == 10
        svc = pkg.SearchService(engine, _hash_encode)
        rows = svc.search_and_display("graph colorings", pkg.SearchFilters(top_k=3))
        assert len(rows) == 3
        assert "graph colorings" in rows[0]["theorem_body"]
        assert rows[0]["theorem_name"].startswith("Theorem 1.1")
        assert rows[0]["paper_title"].startswith("A paper on")
        rows2 = svc.search_and_display("graph colorings", pkg.SearchFilters(
            top_k=5, citation_range=(0, 30), include_unknown_citations=False))
        assert rows2 and all(r["citations"] <= 30 for r in rows2)
        return {"state": _state(engine), "rows": _rows(rows), "rows2": _rows(rows2),
                "exact": _search(engine, _queries(16), 10), "manifest": pkg.manifest()}

    twin(tmp_path, _ten_papers, scenario)


def test_embed_resume(tmp_path):
    def scenario(pkg, tmp):
        b = pkg.IndexBuilder(tmp / "sp2")
        n1 = pkg.P.embed_missing_slogans(pkg.cat, _hash_encode, b, embedder="resume-test", limit=4)
        n2 = pkg.P.embed_missing_slogans(pkg.cat, _hash_encode, b, embedder="resume-test")
        assert (n1, n2, b.total_rows) == (4, 6, 10)
        ids, emb = zip(*b.batches())
        return {"ids": np.concatenate(ids), "emb": np.concatenate(emb), "manifest": pkg.manifest()}

    twin(tmp_path, _ten_papers, scenario)


def test_real_encoder_through_pipeline(tmp_path):
    """A tiny real transformer encoder end to end; the port's carries the
    JAX encoder's weights."""
    cfg = JEncoderConfig.tiny()
    jparams = jax_init_params(cfg, jax.random.PRNGKey(0))

    def setup(cat, sources):
        cat.upsert_paper({"paper_id": "p1", "title": "t", "authors": [], "summary": "",
                          "link": "https://arxiv.org/abs/p1", "last_updated": "2024",
                          "journal_ref": None, "primary_category": "math.AG",
                          "categories": [], "citations": 1})
        cat.replace_theorems("p1", [{"name": "Theorem 1.", "body": "On prime gaps."}], "scanner")
        generate_slogans(cat, load_prompt("body-only-v1"), OfflineStubClient())

    def scenario(pkg, tmp):
        if pkg.jax:
            be = JBatchedEncoder(jparams, cfg, batch_size=4)
        else:
            be = BatchedEncoder(params_from_jax(jax.device_get(jparams), device="cpu"),
                                EncoderConfig.tiny(), batch_size=4, device="cpu")
        engine = pkg.build(tmp / "sp3", encode_fn=be.encode)
        rows = pkg.SearchService(engine, be.encode).search_and_display(
            "prime gaps", pkg.SearchFilters(top_k=1))
        assert len(rows) == 1 and rows[0]["theorem_name"] == "Theorem 1."
        return {"ids": _np(engine.ids, np.int64)[:1], "doc": rows[0]["doc_id"]}

    twin(tmp_path, setup, scenario)


def test_pipeline_residual_capacity_path(tmp_path):
    """The int8-global-residual config: the rebuilt index keeps the global
    scale, hands the engine row-order ids and the residual rescore data
    (the codes bit-equal across packages), and takes the speed route."""
    def scenario(pkg, tmp):
        engine = pkg.build(tmp / "spool_resid", embedder="resid-path",
                           index_config=pkg.IndexConfig(dim=128, pad_multiple=8, dtype="int8",
                                                        int8_scale="global", residual=True))
        assert engine._global_scale > 0, "global_scale lost in the rebuild"
        assert engine.rescore_residual is not None, "residual not adopted"
        n = engine.n_valid
        assert np.array_equal(_np(engine.ids, np.int64)[:n], np.arange(n))
        rows = pkg.SearchService(engine, _hash_encode).search_and_display(
            "graph colorings", pkg.SearchFilters(top_k=3))
        assert len(rows) == 3 and "graph colorings" in rows[0]["theorem_body"]
        if not pkg.jax:
            assert engine.route_counts.get("speed", 0) >= 1
        return {"state": _state(engine), "residual": [_np(a) for a in engine.rescore_residual]}

    twin(tmp_path, _ten_papers, scenario)


def _many_theorems(cat, sources):
    """60 papers of 5 theorems, each theorem's words drawn apart."""
    for p in range(60):
        bodies = [f"Every {WORDS[(p + j) % 16]} {WORDS[(3 * p + 5 * j) % 16]} space "
                  f"of rank r{p}x{j} admits a {WORDS[(7 * p + j) % 16]} cover c{(p * 5 + j) % 37}."
                  for j in range(5)]
        _add_paper(cat, sources, f"2402.{p:05d}", TOPICS[p % 5], bodies, year=f"{2000 + p % 20}",
                   citations=p)
    _ingest(cat, sources)


@pytest.mark.parametrize("layout", ["bfloat16", "int8-global-residual"])
def test_pipeline_few_hundred_theorems(tmp_path, layout):
    """300 theorems through the pipeline in the default (bf16, exact
    route) and the residual speed layout: kept rows, ids and metadata
    equal across packages, equal ids on the exact route, and the recall
    gate (min recall@10 >= 0.99 against the f32 oracle over the packed
    rows) on the speed path."""
    kw = {} if layout == "bfloat16" else {"dtype": "int8", "int8_scale": "global",
                                          "residual": True}

    def scenario(pkg, tmp):
        engine = pkg.build(tmp / "spool", index_config=pkg.IndexConfig(dim=128, **kw))
        assert engine.n_valid == 300
        rec = {"state": _state(engine)}
        q = _queries(64, seed=1)
        if layout == "bfloat16":
            rec["exact"] = _search(engine, q, 10)
            return rec
        b = pkg.IndexBuilder(tmp / "spool")
        ids, emb = map(np.concatenate, zip(*b.batches()))
        corpus = emb[np.argsort(ids)]                     # row order == sorted slogan ids
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
        oracle = np.argsort(-(q @ corpus.T), axis=1, kind="stable")[:, :10]
        _, got = engine.search_vectors(q, k=10)
        rec["recall"] = recall_vs_exact(np.asarray(got), oracle, k=10)
        assert rec["recall"] >= 0.99
        if not pkg.jax:
            assert engine.route_counts.get("speed", 0) >= 1
        return rec

    twin(tmp_path, _many_theorems, scenario)


@pytest.mark.parametrize("layout", ["generator-order", "permuted"])
def test_lane_cell_near_duplicates(layout):
    """Both packages' speed route on a residual index whose near-duplicates
    sit 256 rows apart, as the slogans of chip_smoke.py's catalog do in
    their generator's order: 256 patterns, 32 noisy copies of each, at
    the row block the engine picks for a 100,000-row corpus (1,024).
    Copies in one lane of one tile share one cell of the packed lane
    maxima, so only one of them can be a candidate: the two packages
    return the same ids and lose the same recall in generator order
    (0.878 on these rows), and a seeded permutation of the rows restores
    it (0.997)."""
    from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
    from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
    from theoremsearch_tpu_torch.index.flat import FlatIndex
    from theoremsearch_tpu_torch.search.engine import SearchEngine

    n, period = 8192, 256
    rng = np.random.default_rng(7)
    pattern = rng.standard_normal((period, 128)).astype(np.float32)
    emb = pattern[np.arange(n) % period] + 0.6 * rng.standard_normal((n, 128)).astype(np.float32)
    if layout == "permuted":
        emb = emb[np.random.default_rng(17).permutation(n)]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = _queries(256, seed=3)
    oracle = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :10]
    resid = {"dtype": "int8", "int8_scale": "global", "residual": True}
    jeng = JSearchEngine(JFlatIndex.build(emb, config=JIndexConfig(**resid)), row_block=1024,
                         use_pallas=True, pallas_interpret=True)
    teng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(**resid), device="cpu"),
                        row_block=1024, device="cpu")
    want, got = _search(jeng, q, 10), _search(teng, q, 10)
    _assert_agree(want, got)
    assert jeng._speed_ok and teng.route_counts == {"speed": 1}
    recall = recall_vs_exact(got[2], oracle, k=10)
    assert recall == recall_vs_exact(want[2], oracle, k=10)
    assert recall < 0.95 if layout == "generator-order" else recall >= 0.99


# --------------------------------------------- tests/test_live_refresh.py


def _three_topics(cat, sources):
    _topic_papers(cat, sources, ["prime gaps", "modular forms", "elliptic curves"])


def _two_topics(cat, sources):
    _topic_papers(cat, sources, ["prime gaps", "modular forms"])


def _land_new_paper(pkg, topic="tropical geometry", year="2025-06-01"):
    _add_paper(pkg.cat, pkg.sources, "2407.99999", topic, [f"Every result about {topic} holds."],
               year=year)
    _ingest(pkg.cat, pkg.sources)


def test_refresh_makes_new_docs_searchable(tmp_path):
    def scenario(pkg, tmp):
        engine = pkg.build(tmp / "spool")
        assert engine.n_valid == 3
        assert pkg.refresh(engine) == 0
        _land_new_paper(pkg)
        assert pkg.refresh(engine) == 1
        assert engine.num_live == 4
        rows = engine.search(_hash_encode(["tropical geometry"])[0], pkg.SearchFilters(top_k=2))
        assert rows[0]["paper_title"] == "A paper on tropical geometry"
        assert rows[0]["year"] == 2025
        assert "tropical geometry" in rows[0]["theorem_body"]
        assert pkg.refresh(engine) == 0
        return {"rows": _rows(rows), "manifest": pkg.manifest(), "all": _search(
            engine, _hash_encode(["tropical geometry", "prime gaps"]), 4)}

    twin(tmp_path, _three_topics, scenario)


def test_refresh_with_builder_is_durable(tmp_path):
    def scenario(pkg, tmp):
        spool = tmp / "spool"
        engine = pkg.build(spool)
        assert engine.n_valid == 2
        _land_new_paper(pkg)
        assert pkg.refresh(engine, builder=pkg.IndexBuilder(spool)) == 1
        assert engine.num_live == 3
        engine2 = pkg.build(spool)     # restart: the new doc comes from the spool
        assert engine2.n_valid == 3
        rows = engine2.search(_hash_encode(["tropical geometry"])[0], pkg.SearchFilters(top_k=1))
        assert rows[0]["paper_title"] == "A paper on tropical geometry"
        return {"state": _state(engine2), "manifest": pkg.manifest(),
                "spool_rows": pkg.IndexBuilder(spool).total_rows}

    twin(tmp_path, _two_topics, scenario)


def test_rebuild_serves_only_latest_slogans(tmp_path):
    def scenario(pkg, tmp):
        spool = tmp / "spool"
        assert pkg.build(spool).n_valid == 3
        generate_slogans(pkg.cat, load_prompt("body-and-abstract-v1"), OfflineStubClient())
        engine2 = pkg.build(spool)
        assert engine2.n_valid == 3                  # one doc per theorem, not 6
        rows = engine2.search(_hash_encode(["prime gaps"])[0], pkg.SearchFilters(top_k=3))
        assert len({r["paper_id"] for r in rows}) == 3
        return {"state": _state(engine2), "rows": _rows(rows),
                "spool_rows": pkg.IndexBuilder(spool).total_rows}

    twin(tmp_path, _three_topics, scenario)


def test_refresh_tombstones_superseded_slogan(tmp_path):
    def scenario(pkg, tmp):
        engine = pkg.build(tmp / "spool")
        assert engine.n_valid == 2 and engine.num_live == 2
        before = pkg.manifest()
        generate_slogans(pkg.cat, load_prompt("body-and-abstract-v1"), OfflineStubClient())
        assert pkg.refresh(engine) == 2
        assert engine.num_live == 2                  # 2 tombstoned + 2 added
        rows = engine.search(_hash_encode(["prime gaps"])[0], pkg.SearchFilters(top_k=2))
        assert len({r["paper_id"] for r in rows}) == 2
        assert all(r["doc_id"] >= 2 for r in rows)   # the new slogans
        # every live doc: the superseded ones (0, 1) are gone
        _, s, ids = _search(engine, _hash_encode(["prime gaps", "modular forms"]), 4)
        live = sorted({int(d) for d in ids.ravel() if d >= 0})
        assert live == [2, 3]
        return {"added": sorted(set(pkg.manifest()) - set(before)), "live": live,
                "rows": _rows(rows)}

    twin(tmp_path, _two_topics, scenario)
