"""Port parity: SearchEngine's single-device speed path against the JAX
SearchEngine (Pallas interpret mode), and the recall gate against the
port's fp32 oracle."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

torch.set_num_threads(1)

N, D = 8192, 128
CFG = dict(dtype="int8", int8_scale="global")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((16, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = [
        {"paper_id": f"p{i}", "paper_title": f"Paper {i % 97}", "authors": [f"a{i % 13}"],
         "link": f"https://arxiv.org/abs/2301.{i:05d}" if i % 3 else f"https://stacks.math/{i}",
         "year": 2000 + i % 20, "citations": (i * 7) % 50 if i % 5 else None,
         "theorem_name": "Lemma" if i % 2 else "Theorem", "slogan": f"slogan {i}",
         "theorem_body": f"body $x_{i}$"}
        for i in range(N)
    ]
    return emb, q, rows


@pytest.fixture(scope="module")
def engines(data):
    emb, _, rows = data
    jeng = JSearchEngine(
        JFlatIndex.build(emb, config=JIndexConfig(**CFG)), meta=JCorpusMetadata.from_rows(rows),
        use_pallas=True, pallas_interpret=True, rescore_vectors=emb,
    )
    teng = SearchEngine(
        FlatIndex.build(emb, config=IndexConfig(**CFG), device="cpu"), meta=CorpusMetadata.from_rows(rows),
        rescore_vectors=emb, device="cpu",
    )
    return jeng, teng


def test_speed_path_ids_equal_jax(data, engines):
    _, q, _ = data
    jeng, teng = engines
    assert jeng._speed_ok and teng._speed_ok
    assert teng.row_block == jeng.row_block
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5)


def test_speed_path_recall_gate(data, engines):
    emb, q, _ = data
    _, teng = engines
    _, ids = teng.search_vectors(q, k=10)
    _, oracle = exact_topk(q, emb, k=10, chunk_rows=3000, device="cpu")
    assert recall_vs_exact(ids, oracle, k=10) >= 0.99


def test_odd_batch_pads_and_async_finalize(data, engines):
    _, q, _ = data
    _, teng = engines
    fin = teng.search_vectors_async(q[:5], k=7)
    s, i = fin()
    assert s.shape == i.shape == (5, 7)
    s2, i2 = teng.search_vectors(torch.from_numpy(q[:5]), k=7)
    np.testing.assert_array_equal(i, i2)


@pytest.mark.parametrize("weight", [0.0, 0.05])
def test_search_with_join_and_rerank_matches_jax(data, engines, weight):
    _, q, _ = data
    jeng, teng = engines
    jr = jeng.search(q[3], JSearchFilters(top_k=5, citation_weight=weight))
    tr = teng.search(q[3], SearchFilters(top_k=5, citation_weight=weight))
    assert [r["doc_id"] for r in tr] == [r["doc_id"] for r in jr]
    for a, b in zip(tr, jr):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k not in ("similarity", "score")} == \
            {k: v for k, v in b.items() if k not in ("similarity", "score")}
        assert a["score"] == pytest.approx(b["score"], rel=1e-5)


def test_trivial_filter_served_and_excluding_filter_not_ported(data, engines):
    """A filter that excludes nothing takes the unfiltered path; one that
    excludes rows is now served, with the JAX engine's ids."""
    _, q, _ = data
    jeng, teng = engines
    plain = teng.search_vectors(q[:4], k=10)[1]
    wide = SearchFilters(year_range=(1900, 2100))       # excludes nothing
    np.testing.assert_array_equal(teng.search_vectors(q[:4], k=10, filters=wide)[1], plain)
    _, ti = teng.search_vectors(q[:4], k=10, filters=SearchFilters(sources=("arXiv",)))
    _, ji = jeng.search_vectors(q[:4], k=10, filters=JSearchFilters(sources=("arXiv",)))
    np.testing.assert_array_equal(ti, ji)
    assert (ti % 3 != 0).all()                          # arXiv rows only
    assert teng.search(q[0], SearchFilters(sources=())) == []


def test_unported_configurations_raise(data):
    """A mesh and live updates still raise; a bf16 index and a global
    int8 index without a rescore copy now build on the exact route."""
    emb, _, _ = data
    idx = FlatIndex.build(emb[:2048], config=IndexConfig(**CFG), device="cpu")
    with pytest.raises(NotImplementedError):
        SearchEngine(idx, device="cpu", mesh=object())
    eng = SearchEngine(idx, device="cpu")                # no rescore copy
    assert not eng._speed_ok
    with pytest.raises(NotImplementedError):
        eng.add_documents(emb[:1])
    with pytest.raises(NotImplementedError):
        eng.delete_documents([0])
    bf = SearchEngine(FlatIndex.build(emb[:2048], config=IndexConfig(dtype="bfloat16"), device="cpu"),
                      rescore_vectors=emb[:2048], device="cpu")
    assert not bf._speed_ok and bf.search_vectors(emb[:2], k=1)[1][:, 0].tolist() == [0, 1]


def test_engine_without_device_needs_the_card(data, monkeypatch):
    """Entry points run on the card unless given a device: with no CUDA,
    a SearchEngine without one raises instead of running on the CPU."""
    emb, _, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchEngine(FlatIndex.build(emb[:2048], config=IndexConfig(**CFG), device="cpu"), rescore_vectors=emb[:2048])
