"""Port parity: the engine's IVF route (SearchEngine(ivf_index=...))
against the JAX reference's engine on the same reference-built index
(Pallas in interpret mode there, the plain B6 here), on the
`pallas_scale_corpus` fixture of tests/test_ivf.py. Small unfiltered
batches probe; larger or filtered ones take the flat routes."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import IndexConfig as JIndexConfig
from theoremsearch_tpu.eval.oracle import l2_normalize
from theoremsearch_tpu.index import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.ivf import IVFIndex as JIVFIndex
from theoremsearch_tpu.search import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu.search import SearchEngine as JSearchEngine
from theoremsearch_tpu.search import SearchFilters as JSearchFilters
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.builder import IndexBuilder
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
from theoremsearch_tpu_torch.search.engine import SearchEngine

torch.set_num_threads(2)
CPU = "cpu"


def _rows(n):
    return [
        {"paper_id": f"p{i}", "paper_title": f"T{i}", "authors": [],
         "link": "https://arxiv.org/abs/x", "year": 2000 + (i % 30),
         "primary_category": "math.AG", "journal_ref": None, "citations": i,
         "theorem_name": "Theorem 1.", "theorem_body": "b", "slogan": "s"}
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(3)
    centers = np.asarray(l2_normalize(rng.standard_normal((32, 128)).astype(np.float32)))
    assign = rng.integers(0, 32, 16384)
    pts = centers[assign] + (0.7 / np.sqrt(128)) * rng.standard_normal((16384, 128)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    q = centers[rng.integers(0, 32, 40)] + (0.7 / np.sqrt(128)) * rng.standard_normal((40, 128)).astype(np.float32)
    queries = np.asarray(l2_normalize(q))
    jidx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=32, dtype="int8", ivf_assign2_margin=0.02),
                           slab_rows=768, normalize=False)
    path = tmp_path_factory.mktemp("ivf") / "ivf"
    jidx.save(path)
    return emb, queries, jidx, IVFIndex.load(path, device=CPU)


@pytest.fixture(scope="module")
def engines(corpus):
    emb, _, jidx, tidx = corpus
    rows = _rows(emb.shape[0])
    jeng = JSearchEngine(
        JFlatIndex.build(emb, config=JIndexConfig(pad_multiple=1024, dtype="float32"), normalize=False),
        meta=JCorpusMetadata.from_rows(rows), use_pallas=True, pallas_interpret=True, row_block=128,
        ivf_index=jidx, ivf_nprobe=8, rescore_factor=8,
    )
    teng = SearchEngine(
        FlatIndex.build(emb, config=IndexConfig(pad_multiple=1024, dtype="float32"), normalize=False,
                        device=CPU),
        meta=CorpusMetadata.from_rows(rows), row_block=128, ivf_index=tidx, ivf_nprobe=8,
        rescore_factor=8, device=CPU,
    )
    return jeng, teng


@pytest.mark.parametrize("b", [16, 5, 1])
def test_ivf_route_ids_equal_reference_engine(corpus, engines, b):
    emb, q, _, _ = corpus
    jeng, teng = engines
    before = teng.route_counts.get("ivf", 0)
    js, ji = jeng.search_vectors(q[:b], k=10)
    ts, ti = teng.search_vectors(q[:b], k=10)
    assert teng.route_counts["ivf"] == before + 1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    ref = exact_topk(q[:b], emb, k=10, device=CPU)[1]
    assert recall_vs_exact(ti, ref, k=10) >= 0.95


def test_larger_batches_take_the_flat_route(corpus, engines):
    _, q, _, _ = corpus
    jeng, teng = engines
    r0 = dict(teng.route_counts)
    js, ji = jeng.search_vectors(q[:17], k=10)
    ts, ti = teng.search_vectors(q[:17], k=10)
    assert teng.route_counts.get("ivf", 0) == r0.get("ivf", 0)
    assert teng.route_counts["exact"] == r0.get("exact", 0) + 1
    np.testing.assert_array_equal(ti, ji)


def test_filtered_batches_never_probe(corpus, engines):
    _, q, _, _ = corpus
    jeng, teng = engines
    r0 = dict(teng.route_counts)
    f = SearchFilters(year_range=(2000, 2004))
    _, ti = teng.search_vectors(q[:2], k=5, filters=f)
    assert teng.route_counts.get("ivf", 0) == r0.get("ivf", 0)
    assert all(2000 + (int(d) % 30) <= 2004 for d in ti.ravel() if d >= 0)
    _, ji = jeng.search_vectors(q[:2], k=5, filters=JSearchFilters(year_range=(2000, 2004)))
    np.testing.assert_array_equal(ti, ji)
    # a broad filter (over-fetch on the flat route) does not probe either
    _, tb = teng.search_vectors(q[:2], k=5, filters=SearchFilters(year_range=(2000, 2025)))
    assert teng.route_counts.get("ivf", 0) == r0.get("ivf", 0)
    assert all(2000 + (int(d) % 30) <= 2025 for d in tb.ravel() if d >= 0)


def test_async_equals_sync_and_metadata_join(corpus, engines):
    _, q, _, _ = corpus
    _, teng = engines
    s, i = teng.search_vectors(q[:8], k=10)
    s2, i2 = teng.search_vectors_async(q[:8], k=10)()
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_array_equal(s, s2)
    # device tensors in, as the scheduler sends them
    s3, i3 = teng.search_vectors(torch.tensor(q[:8]), k=10)
    np.testing.assert_array_equal(i, i3)
    teng.warm_overfetch(batch_sizes=(1, 8, 64), k=10)
    out = teng.search(q[0], SearchFilters(top_k=5))
    assert len(out) == 5 and all("paper_title" in r and "similarity" in r for r in out)
    assert [r["doc_id"] for r in out] == i[0, :5].tolist()


def test_nprobe_rule(corpus, tmp_path):
    """An explicit nprobe wins; a calibrated index's nprobe is trusted
    verbatim; else 16."""
    emb, _, _, tidx = corpus
    flat = FlatIndex.build(emb, config=IndexConfig(pad_multiple=1024, dtype="float32"), normalize=False,
                           device=CPU)
    assert SearchEngine(flat, ivf_index=tidx, device=CPU).ivf_nprobe == 16
    assert SearchEngine(flat, ivf_index=tidx, ivf_nprobe=3, device=CPU).ivf_nprobe == 3
    b = IndexBuilder(tmp_path / "sp", IndexConfig(ivf_nlist=32, dtype="int8", int8_scale="global",
                                                   ivf_assign2_margin=0.02))
    b.add(np.arange(emb.shape[0], dtype=np.int64), emb)
    ivf, calib = b.finalize_ivf(calibrate_gate=0.9, slab_rows=768, device=CPU)
    assert ivf.config.ivf_nprobe_calibrated
    eng = SearchEngine(flat, ivf_index=ivf, rescore_factor=8, device=CPU)
    assert eng.ivf_nprobe == calib[0]
    _, ids = eng.search_vectors(emb[:4], k=1)
    assert eng.route_counts == {"ivf": 1}
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
