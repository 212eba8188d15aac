"""Port parity: the list-sharded IVF searcher (`IVFIndex.sharded_searcher`)
and the engine's IVF route under a mesh against the JAX package on its
8-device CPU mesh, twins of the mesh cases of tests/test_ivf.py.

One index for both packages: the reference builds it, the port loads its
saved copy (k-means differs by design). Ids must be equal wherever the
scores are unique (`test_torch_live_updates._agree`), scores within
1e-5; the reference tests' recall gates hold too. The JAX side runs its
kernel in interpret mode, or its XLA scan where the reference test
does."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.eval.oracle import l2_normalize
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.ivf import IVFIndex as JIVFIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.index import ivf as ivf_mod
from theoremsearch_tpu_torch.kernels.mips import ivf_probe_scores
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

from test_torch_live_updates import _agree
from torch_helpers import cpu_mesh, serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()


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
    """The reference's pallas_scale_corpus: 32 clusters x ~512 members at
    D=128, and the index built by the JAX package (plain and residual)."""
    rng = np.random.default_rng(3)
    centers = np.asarray(l2_normalize(rng.standard_normal((32, 128)).astype(np.float32)))
    assign = rng.integers(0, 32, 16384)
    pts = centers[assign] + (0.7 / np.sqrt(128)) * rng.standard_normal((16384, 128)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    q = centers[rng.integers(0, 32, 16)] + (0.7 / np.sqrt(128)) * rng.standard_normal((16, 128)).astype(np.float32)
    queries = np.asarray(l2_normalize(q))
    out = {}
    for residual in (False, True):
        jidx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=32, dtype="int8", ivf_assign2_margin=0.02,
                                                        residual=residual),
                               slab_rows=768, normalize=False)
        path = tmp_path_factory.mktemp("ivf") / "ivf"
        jidx.save(path)
        out[residual] = (jidx, IVFIndex.load(path, device="cpu"))
    return emb, queries, out


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("residual", [False, True])
def test_sharded_ivf_matches_reference(corpus, shards, residual, monkeypatch):
    """Lists sharded over the mesh, B6 a shard, the merge with the
    cross-shard dedupe: the JAX sharded searcher's ids (its Pallas kernel
    in interpret mode), recall >= 0.95, no repeated id in a row, scores
    descending; within 0.05 of the single-device recall; in the residual
    mode near-f32 scores (twins of test_sharded_ivf_matches_oracle and
    test_sharded_ivf_residual)."""
    emb, q, idx = corpus
    jidx, tidx = idx[residual]
    js, ji = jidx.sharded_searcher(j_make_mesh(JMeshConfig(data=1, shard=shards)), k=10, nprobe=8,
                                   rescore_factor=8, interpret=True)(q)
    calls = []
    monkeypatch.setattr(ivf_mod, "ivf_probe_scores",
                        lambda *a: calls.append(a[1].shape) or ivf_probe_scores(*a))
    ts, ti = tidx.sharded_searcher(cpu_mesh(shards), k=10, nprobe=8, rescore_factor=8)(q)
    assert len(calls) == shards                       # B6 once a shard, on its own chunks
    ts, ti = ts.numpy(), ti.numpy()
    _agree(np.asarray(js), np.asarray(ji), ts, ti, f"sharded IVF x{shards}")
    ref = exact_topk(q, emb, k=10, device="cpu")[1]
    rec = recall_vs_exact(ti, ref, k=10)
    assert rec >= 0.95, rec
    for row in ti:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    assert all(np.all(np.diff(row) <= 1e-6) for row in ts)
    _, i1 = tidx.search(q, k=10, nprobe=8, rescore_factor=8)
    assert abs(rec - recall_vs_exact(i1, ref, k=10)) <= 0.05
    if residual:
        exp = np.take_along_axis(q @ emb.T, np.clip(ti, 0, None), 1)
        np.testing.assert_allclose(ts[ti >= 0], exp[ti >= 0], atol=5e-4)


def test_sharded_ivf_against_xla_reference(corpus):
    """The reference's XLA form of the sharded search (use_pallas=False)
    selects the same candidates: equal ids (twin of
    test_sharded_ivf_xla_fallback)."""
    emb, q, idx = corpus
    jidx, tidx = idx[False]
    js, ji = jidx.sharded_searcher(j_make_mesh(JMeshConfig(data=1, shard=4)), k=10, nprobe=8,
                                   rescore_factor=8, use_pallas=False)(q)
    ts, ti = tidx.sharded_searcher(cpu_mesh(4), k=10, nprobe=8, rescore_factor=8)(q)
    _agree(np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy(), "sharded IVF vs XLA")
    assert recall_vs_exact(ti.numpy(), exact_topk(q, emb, k=10, device="cpu")[1], k=10) >= 0.95


def test_sharded_ivf_refuses_what_it_cannot_search(corpus, tmp_path):
    """The reference's preconditions: int8, rescore data, slab rows a
    multiple of 128."""
    emb, _, _ = corpus
    jidx = JIVFIndex.build(emb[:4096], config=JIndexConfig(ivf_nlist=8, dtype="float32"),
                           slab_rows=768, normalize=False)
    jidx.save(tmp_path / "f32")
    tidx = IVFIndex.load(tmp_path / "f32", device="cpu")
    with pytest.raises(ValueError, match="sharded IVF"):
        tidx.sharded_searcher(cpu_mesh(2), k=5)


def test_engine_ivf_route_under_mesh(corpus):
    """The engine over a mesh routes small unfiltered batches through the
    list-sharded searcher and keeps filters (the flat sharded route),
    metadata and deletes (over-fetch + host drop): the JAX mesh engine's
    ids at every step, recall >= 0.95, overlap >= 0.9 with the
    single-device IVF engine (twin of test_engine_ivf_route_under_mesh)."""
    emb, q, idx = corpus
    jidx, tidx = idx[False]
    rows = _rows(emb.shape[0])
    jflat = JFlatIndex.build(emb, config=JIndexConfig(pad_multiple=1024, dtype="float32"), normalize=False)
    tflat = FlatIndex.build(emb, config=IndexConfig(pad_multiple=1024, dtype="float32"), normalize=False,
                            device="cpu")
    jeng = JSearchEngine(jflat, meta=JCorpusMetadata.from_rows(rows),
                         mesh=j_make_mesh(JMeshConfig(data=1, shard=4)), use_pallas=True,
                         pallas_interpret=True, row_block=128, ivf_index=jidx, ivf_nprobe=8,
                         rescore_factor=8)

    def teng(mesh):
        return SearchEngine(tflat, meta=CorpusMetadata.from_rows(rows), mesh=mesh,
                            device=None if mesh is not None else "cpu", row_block=128, ivf_index=tidx,
                            ivf_nprobe=8, rescore_factor=8)

    eng_m, eng_1 = teng(cpu_mesh(4)), teng(None)
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = eng_m.search_vectors(q, k=10)
    _agree(js, ji, ts, ti, "meshed IVF engine")
    assert eng_m.route_counts == {"ivf": 1}
    ref = exact_topk(q, emb, k=10, device="cpu")[1]
    assert recall_vs_exact(ti, ref, k=10) >= 0.95
    _, i1 = eng_1.search_vectors(q, k=10)
    assert np.mean([len(set(ti[r]) & set(i1[r])) / 10 for r in range(len(q))]) >= 0.9
    # filtered queries take the flat sharded route and respect the filter
    js, ji = jeng.search_vectors(q[:2], k=5, filters=JSearchFilters(year_range=(2000, 2004)))
    ts, ti_f = eng_m.search_vectors(q[:2], k=5, filters=SearchFilters(year_range=(2000, 2004)))
    _agree(js, ji, ts, ti_f, "meshed IVF engine, filtered")
    assert all(2000 + (int(d) % 30) <= 2004 for d in ti_f.ravel() if d >= 0)
    # deletes keep the sharded IVF route through the over-fetch
    victims = [int(d) for d in ti[0][:3]]
    assert jeng.delete_documents(victims) == eng_m.delete_documents(victims) == 3
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti2 = eng_m.search_vectors(q, k=10)
    _agree(js, ji, ts, ti2, "meshed IVF engine after deletes")
    assert not set(victims) & {int(d) for d in ti2.ravel()}
    assert eng_m.route_counts.get("overfetch", 0) == 0 and eng_m.route_counts["ivf"] == 2
    out = eng_m.search(q[0], SearchFilters(top_k=5))
    assert out and all("paper_title" in r and "similarity" in r for r in out)
