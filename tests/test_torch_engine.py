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
        FlatIndex.build(emb, config=IndexConfig(**CFG)), meta=CorpusMetadata.from_rows(rows),
        rescore_vectors=emb,
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
    _, oracle = exact_topk(q, emb, k=10, chunk_rows=3000)
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
    _, q, _ = data
    _, teng = engines
    plain = teng.search_vectors(q[:4], k=10)[1]
    wide = SearchFilters(year_range=(1900, 2100))       # excludes nothing
    np.testing.assert_array_equal(teng.search_vectors(q[:4], k=10, filters=wide)[1], plain)
    with pytest.raises(NotImplementedError):
        teng.search_vectors(q[:4], k=10, filters=SearchFilters(sources=("arXiv",)))
    assert teng.search(q[0], SearchFilters(sources=())) == []


def test_unported_configurations_raise(data):
    emb, _, _ = data
    with pytest.raises(NotImplementedError):
        SearchEngine(FlatIndex.build(emb[:2048], config=IndexConfig(**CFG)))   # no rescore copy
    with pytest.raises(NotImplementedError):
        SearchEngine(FlatIndex.build(emb[:2048], config=IndexConfig(dtype="bfloat16")),
                     rescore_vectors=emb[:2048])
