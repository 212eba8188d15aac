"""Port parity: live updates (theoremsearch_tpu_torch/search/delta.py and
SearchEngine's add / update / delete / compact / reclaim) against the JAX
engine, twins of the single-device cases of tests/test_live_updates.py.

Each case is written once as a scenario over a package namespace and run
twice, on the JAX package (Pallas in interpret mode, as its own tests run
it) and on the port on the CPU. Every search the scenario makes on the
main thread is logged; the two logs must agree: ids equal wherever the
scores are unique (a neighbouring score further than 1e-5), scores within
1e-5. The scenario's own checks (ids against the f32 oracle over the live
rows) run on both packages. Concurrent cases log only their quiesced
searches."""

import atexit
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.ivf import IVFIndex as JIVFIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

from torch_helpers import ids_agree, serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()
TOL = 1e-5


def _norm(x):
    x = np.asarray(x, np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _small():
    rng = np.random.default_rng(0)
    return (_norm(rng.standard_normal((600, 64))), _norm(rng.standard_normal((20, 64))),
            _norm(rng.standard_normal((9, 64))))


def _meta_rows(n, start=0, year=2010):
    return [
        {"paper_id": f"p{start + i}", "paper_title": f"Paper {start + i}",
         "authors": [f"A{(start + i) % 7}"], "link": f"https://arxiv.org/abs/{start + i}",
         "year": year, "primary_category": "math.AG", "journal_ref": None, "citations": 3,
         "theorem_name": "Theorem 1.", "theorem_body": f"body {start + i}",
         "slogan": f"slogan {start + i}"}
        for i in range(n)
    ]


def _oracle(q, live_vecs, live_ids, k):
    s = q @ live_vecs.T
    order = np.argsort(-s, axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), live_ids[order]


# ---------------------------------------------------------------- the twin


class Rec:
    """An engine whose main-thread searches are logged."""

    def __init__(self, eng, log):
        object.__setattr__(self, "raw", eng)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, name):
        return getattr(self.raw, name)

    def __setattr__(self, name, value):
        setattr(self.raw, name, value)

    def _rec(self, out):
        if threading.current_thread() is threading.main_thread():
            self._log.append((np.array(out[0], np.float32), np.array(out[1], np.int64)))
        return out

    def search_vectors(self, *a, **kw):
        return self._rec(self.raw.search_vectors(*a, **kw))

    def search_vectors_async(self, *a, **kw):
        fin = self.raw.search_vectors_async(*a, **kw)
        return lambda: self._rec(fin())

    def search(self, *a, **kw):
        rows = self.raw.search(*a, **kw)
        self._rec(([[r["similarity"] for r in rows]], [[r["doc_id"] for r in rows]]))
        return rows


_IVF_DIR = tempfile.mkdtemp(prefix="twin_ivf_")
atexit.register(shutil.rmtree, _IVF_DIR, True)
_IVF_CACHE: dict = {}


class Pkg:
    """One package's names, and engines built the reference tests' way."""

    def __init__(self, name: str, log: list):
        self.torch = name == "torch"
        self.log = log
        self.IndexConfig = IndexConfig if self.torch else JIndexConfig
        self.CorpusMetadata = CorpusMetadata if self.torch else JCorpusMetadata
        self.SearchFilters = SearchFilters if self.torch else JSearchFilters

    def build(self, emb, ids=None, config=None, normalize=False):
        if self.torch:
            return FlatIndex.build(emb, ids=ids, config=config, normalize=normalize, device="cpu")
        return JFlatIndex.build(emb, ids=ids, config=config, normalize=normalize)

    def engine(self, idx, pallas: bool, **kw):
        if self.torch:
            return Rec(SearchEngine(idx, device="cpu", **kw), self.log)
        return Rec(JSearchEngine(idx, use_pallas=pallas, pallas_interpret=pallas, **kw), self.log)

    def fp32_engine(self, emb, meta=None, ids=None, **kw):
        idx = self.build(emb, ids=ids, config=self.IndexConfig(pad_multiple=128, dtype="float32"))
        return self.engine(idx, False, meta=meta, row_block=128, **kw)

    def speed_engine(self, emb, meta=None, residual=False):
        idx = self.build(emb, config=self.IndexConfig(pad_multiple=256, dtype="int8",
                                                      int8_scale="global", residual=residual))
        kw = {} if residual else {"rescore_vectors": emb}
        return self.engine(idx, True, meta=meta, row_block=128, rescore_factor=8, **kw)

    def ivf(self, emb, key: str, **cfg):
        """One IVF index for both packages: the reference builds it, the
        port loads its saved copy (k-means differs by design)."""
        if key not in _IVF_CACHE:
            jidx = JIVFIndex.build(emb, config=JIndexConfig(**cfg), slab_rows=128, normalize=False)
            jidx.save(Path(_IVF_DIR) / key)
            _IVF_CACHE[key] = jidx
        if self.torch:
            return IVFIndex.load(Path(_IVF_DIR) / key, device="cpu")
        return _IVF_CACHE[key]

    @staticmethod
    def np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def scheduler(self, eng, **kw):
        if self.torch:
            from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler
        else:
            from theoremsearch_tpu.serve.scheduler import BatchScheduler
        return BatchScheduler(eng.raw, **kw)


def _agree(sj, ij, st, it, where):
    ids_agree(sj, ij, st, it, TOL, where)


def twin(scenario, *args, pkg=None):
    """Run `scenario(pkg, *args)` on both packages; their logged searches
    must agree. `pkg`: the package-namespace class (default `Pkg`)."""
    pkg = pkg or Pkg
    logs = {}
    for name in ("jax", "torch"):
        logs[name] = []
        scenario(pkg(name, logs[name]), *args)
    assert len(logs["jax"]) == len(logs["torch"]) > 0
    for n, ((sj, ij), (st, it)) in enumerate(zip(logs["jax"], logs["torch"])):
        _agree(sj, ij, st, it, f"search {n} of {scenario.__name__}")


# ------------------------------------------------------------- scenarios


def add_documents_searchable_immediately(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    ids = eng.add_documents(new, normalize=False)
    assert list(ids) == list(range(600, 620))
    s, i = eng.search_vectors(new, k=1)
    np.testing.assert_array_equal(i[:, 0], ids)
    assert (s[:, 0] > 0.999).all()
    ref_s, ref_i = _oracle(q, np.concatenate([emb, new]), np.arange(620), 10)
    s, i = eng.search_vectors(q, k=10)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=2e-3)
    assert eng.num_live == 620


def delete_main_and_delta(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    ids = eng.add_documents(new[:5], normalize=False)
    s0, i0 = eng.search_vectors(q, k=5)
    victims = [int(i0[0, 0]), int(i0[0, 1]), 17, int(ids[0]), int(ids[3])]
    assert eng.delete_documents(victims) == 5
    assert eng.num_live == 600
    s, i = eng.search_vectors(q, k=10)
    live = (set(range(600)) | {int(x) for x in ids}) - set(victims)
    assert set(i.ravel().tolist()) <= live
    keep = np.array(sorted(live))
    _, ref_i = _oracle(q, np.concatenate([emb, new[:5]])[keep], keep, 10)
    np.testing.assert_array_equal(i, ref_i)


def update_document_replaces_vector(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    eng.update_document(42, new[0])
    s, i = eng.search_vectors(new[0][None, :], k=1)
    assert int(i[0, 0]) == 42 and s[0, 0] > 0.999
    _, i2 = eng.search_vectors(emb[42][None, :], k=1)
    assert int(i2[0, 0]) != 42
    assert eng.num_live == 600
    assert eng.delete_documents([42]) == 1
    _, i3 = eng.search_vectors(new[0][None, :], k=3)
    assert 42 not in i3[0].tolist()


def delta_docs_respect_filters_and_join(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600, year=2005)))
    ids = eng.add_documents(new[:4], meta_rows=_meta_rows(4, start=600, year=2021), normalize=False)
    _, i = eng.search_vectors(new[:4], k=2, filters=P.SearchFilters(year_range=(2020, 2022)))
    np.testing.assert_array_equal(i[:, 0], ids)
    assert (i >= 600).all()
    _, i2 = eng.search_vectors(new[:4], k=2, filters=P.SearchFilters(year_range=(2000, 2010)))
    assert (i2 < 600).all()
    rows = eng.search(new[0], P.SearchFilters(top_k=3))
    assert rows[0]["doc_id"] == int(ids[0])
    assert rows[0]["paper_title"] == "Paper 600" and rows[0]["theorem_slogan"] == "slogan 600"


def add_requires_meta_rows_when_meta(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    with pytest.raises(ValueError, match="meta_rows"):
        eng.add_documents(new[:2])
    eng.search_vectors(q, k=3)


def speed_path_live_updates(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    assert eng._speed_ok
    ids = eng.add_documents(new, normalize=False)
    _, i = eng.search_vectors(new[:8], k=1)
    np.testing.assert_array_equal(i[:, 0], ids[:8])
    _, i0 = eng.search_vectors(q[:1], k=1)
    victim = int(i0[0, 0])
    eng.delete_documents([victim])
    _, i1 = eng.search_vectors(q[:1], k=10)
    assert victim not in i1[0].tolist()
    keep = np.array([d for d in range(620) if d != victim])
    _, ref_i = _oracle(q, np.concatenate([emb, new])[keep], keep, 10)
    _, i2 = eng.search_vectors(q, k=10)
    assert (i2[:, :, None] == ref_i[:, None, :]).any(2).mean() >= 0.98


def compact_folds_delta(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    ids = eng.add_documents(new, normalize=False)
    eng.delete_documents([7, int(ids[2])])
    s_before, i_before = eng.search_vectors(q, k=10)
    assert eng.compact() == 19
    assert eng._delta is None or eng._delta.n == 0
    assert eng._speed_ok and eng.n_valid == 620
    s_after, i_after = eng.search_vectors(q, k=10)
    np.testing.assert_array_equal(i_before, i_after)
    np.testing.assert_allclose(s_before, s_after, atol=2e-3)
    assert 7 not in i_after.ravel().tolist()
    assert eng.num_live == 618
    ids2 = eng.add_documents(new[:2], normalize=False)
    _, i = eng.search_vectors(new[:2], k=1)
    np.testing.assert_array_equal(i[:, 0], ids2)


def update_then_compact_keeps_arange(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    eng.update_document(100, new[0])
    eng.add_documents(new[1:3], normalize=False)
    assert eng.compact() == 3
    assert eng._speed_ok and eng.n_valid == 602
    np.testing.assert_array_equal(P.np(eng.index.ids)[:602], np.arange(602))
    _, i = eng.search_vectors(new[0][None, :], k=1)
    assert int(i[0, 0]) == 100
    assert eng.num_live == 602


def compact_residual_mode(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb, residual=True)
    assert eng.rescore_residual is not None
    ids = eng.add_documents(new[:6], normalize=False)
    _, i = eng.search_vectors(new[:6], k=1)
    np.testing.assert_array_equal(i[:, 0], ids)
    assert eng.compact() == 6
    assert eng.rescore_residual[0].shape[0] == 606
    _, i2 = eng.search_vectors(new[:6], k=1)
    np.testing.assert_array_equal(i2[:, 0], ids)
    eng.search_vectors(q, k=10)


def all_main_deleted_serves_from_delta(P):
    rng = np.random.default_rng(3)
    emb = _norm(rng.standard_normal((64, 32)))
    new = _norm(rng.standard_normal((3, 32)))
    eng = P.fp32_engine(emb)
    ids = eng.add_documents(new, normalize=False)
    eng.delete_documents(list(range(64)))
    _, i = eng.search_vectors(new, k=5)
    assert set(i[:, 0].tolist()) == {int(x) for x in ids}
    assert (i[:, 3:] == -1).all()


def delta_capacity_growth(P):
    rng = np.random.default_rng(4)
    emb = _norm(rng.standard_normal((128, 16)))
    eng = P.fp32_engine(emb)
    a = _norm(rng.standard_normal((900, 16)))
    b = _norm(rng.standard_normal((300, 16)))
    eng.add_documents(a, normalize=False)
    eng.add_documents(b, normalize=False)
    assert eng._delta.cap == 2048
    assert eng.num_live == 128 + 1200
    _, i = eng.search_vectors(np.concatenate([a[895:], b[:3]]), k=1)
    np.testing.assert_array_equal(i[:, 0], [1023, 1024, 1025, 1026, 1027, 1028, 1029, 1030])


def vector_only_custom_meta_none(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    ids1 = eng.add_documents(new[:2], normalize=False)
    ids2 = eng.add_documents(new[2:4], normalize=False)
    assert list(ids1) == [600, 601] and list(ids2) == [602, 603]
    assert eng._join(np.array([602]), np.array([0.5]))[0]["doc_id"] == 602
    eng.search_vectors(q, k=4)


def compact_after_deleting_lowest_new_id(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    ids = eng.add_documents(new[:5], normalize=False)
    eng.delete_documents([int(ids[0])])
    _, i_before = eng.search_vectors(q, k=10)
    assert eng.compact() == 4
    assert eng._speed_ok and eng.n_valid == 605 and eng.num_live == 604
    np.testing.assert_array_equal(P.np(eng.index.ids)[:605], np.arange(605))
    _, i_after = eng.search_vectors(q, k=10)
    np.testing.assert_array_equal(i_before, i_after)
    _, i = eng.search_vectors(new[:5], k=1)
    np.testing.assert_array_equal(i[1:5, 0], ids[1:5])
    assert int(i[0, 0]) != 600


def compact_all_delta_deleted_folds_gap(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    ids = eng.add_documents(new[:3], normalize=False)
    eng.delete_documents([int(x) for x in ids] + [5])
    _, i_before = eng.search_vectors(q, k=10)
    assert eng.compact() == 0
    assert eng._delta is None and eng.n_valid == 603 and eng._main_ids_arange
    _, i_after = eng.search_vectors(q, k=10)
    np.testing.assert_array_equal(i_before, i_after)
    assert eng.num_live == 599 and 5 not in i_after.ravel().tolist()
    ids2 = eng.add_documents(new[3:5], normalize=False)
    assert list(ids2) == [603, 604]
    _, i2 = eng.search_vectors(new[3:5], k=1)
    np.testing.assert_array_equal(i2[:, 0], ids2)
    assert eng.compact() == 2
    assert eng._main_ids_arange and eng.n_valid == 605
    _, i3 = eng.search_vectors(new[3:5], k=1)
    np.testing.assert_array_equal(i3[:, 0], ids2)
    assert list(eng.add_documents(new[5:6], normalize=False)) == [605]
    _, i4 = eng.search_vectors(new[5:6], k=1)
    assert int(i4[0, 0]) == 605


def compact_concurrent_with_queries(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    errs, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                _, i = eng.search_vectors(q, k=5)
                assert i.shape == (9, 5) and (i >= 0).all()
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                return

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for j in range(4):
            eng.add_documents(new[5 * j : 5 * j + 5], normalize=False)
            assert eng.compact() == 5
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errs, errs
    assert eng.n_valid == 620 and eng._main_ids_arange
    eng.search_vectors(q, k=5)


def compact_update_then_delete_is_noop(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    eng.update_document(5, new[0])
    eng.delete_documents([5])
    vecs_before = eng.vectors
    assert eng.compact() == 0
    assert eng._delta is None and eng.n_valid == 600 and eng.vectors is vecs_before
    assert eng.num_live == 599
    _, i = eng.search_vectors(q, k=10)
    assert 5 not in i.ravel().tolist()


def add_with_meta_requires_arange_ids(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)),
                        ids=np.arange(1000, 1600, dtype=np.int64))
    with pytest.raises(ValueError, match="row-order doc ids"):
        eng.add_documents(new[:2], meta_rows=_meta_rows(2, 600), normalize=False)
    eng.search_vectors(q, k=3)


def compact_custom_ids(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, ids=np.arange(1000, 1600, dtype=np.int64))
    ids = eng.add_documents(new[:4], normalize=False)
    assert list(ids) == [1600, 1601, 1602, 1603]
    eng.delete_documents([1601])
    assert eng.compact() == 3
    assert eng.n_valid == 604 and eng.num_live == 603
    _, i = eng.search_vectors(new[:4], k=1)
    assert i[0, 0] == 1600 and i[2, 0] == 1602 and i[3, 0] == 1603 and i[1, 0] != 1601
    assert eng.delete_documents([1000]) == 1
    eng.search_vectors(q, k=5)


def tombstone_overfetch_stays_on_fast_path(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    victims = np.random.default_rng(1).choice(600, size=30, replace=False).tolist()
    assert eng.delete_documents(victims) == 30
    s, i = eng.search_vectors(q, k=10)
    keep = np.array(sorted(set(range(600)) - set(victims)))
    ref_s, ref_i = _oracle(q, emb[keep], keep, 10)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=2e-3)
    assert eng._tomb_mask_cache == {}
    eng2 = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    eng2.delete_documents(victims)
    _, i2 = eng2.search_vectors(q, k=5, filters=P.SearchFilters(top_k=5, year_range=(2005, 2020)))
    assert eng2._tomb_mask_cache
    assert not set(i2.ravel().tolist()) & set(victims)


def tombstone_overfetch_fallback_exact(P):
    rng = np.random.default_rng(7)
    d = 32
    q0 = _norm(rng.standard_normal((1, d)))
    emb = np.concatenate([_norm(q0 + 0.001 * rng.standard_normal((70, d))),
                          _norm(q0 + 0.9 * rng.standard_normal((40, d))),
                          _norm(rng.standard_normal((400, d)))])
    eng = P.fp32_engine(emb)
    assert eng.delete_documents(list(range(70))) == 70
    _, i = eng.search_vectors(q0, k=5)
    keep = np.arange(70, emb.shape[0])
    np.testing.assert_array_equal(i, _oracle(q0, emb[keep], keep, 5)[1])
    assert eng._tomb_mask_cache
    q1 = _norm(rng.standard_normal((4, d)))
    _, i1 = eng.search_vectors(q1, k=5)
    np.testing.assert_array_equal(i1, _oracle(q1, emb[keep], keep, 5)[1])


def _cyclic_years(rows):
    for i, r in enumerate(rows):
        r["year"] = 2000 + (i % 10)
    return rows


def broad_filter_overfetch_matches_masked_path(P):
    emb, new, q = _small()
    rows = _cyclic_years(_meta_rows(600))
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(rows))
    broad = P.SearchFilters(top_k=10, year_range=(2000, 2007))
    s, i = eng.search_vectors(q, k=10, filters=broad)
    masked = (lambda: "exact_masked" in eng.route_counts) if P.torch else (
        lambda: any(kk[1] in ("mask", True) for kk in eng._search_fn_cache))
    assert not masked(), "a broad filter should not take the masked route"
    s_ref, i_ref = eng.search_vectors_async(q, 10, broad, _force_masked=True)()
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, atol=2e-3)
    years = np.array([r["year"] for r in rows])
    assert ((years[i] >= 2000) & (years[i] <= 2007)).all()
    _, i2 = eng.search_vectors(q, k=10, filters=P.SearchFilters(top_k=10, year_range=(2008, 2009)))
    assert masked()
    assert ((years[i2] >= 2008) & (years[i2] <= 2009)).all()


def broad_filter_overfetch_with_tombstones_and_delta(P):
    emb, new, q = _small()
    rows = _cyclic_years(_meta_rows(600))
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(rows))
    eng.add_documents(new[:4], meta_rows=_meta_rows(4, start=600, year=2003), normalize=False)
    victims = set(range(60))
    eng.delete_documents(sorted(victims))
    _, i = eng.search_vectors(q, k=10, filters=P.SearchFilters(top_k=10, year_range=(2000, 2007)))
    years = np.array([r["year"] for r in rows] + [2003] * 4)
    flat = i[i >= 0]
    assert not set(flat.tolist()) & victims
    assert ((years[flat] >= 2000) & (years[flat] <= 2007)).all()
    passing = np.array([d for d in range(604) if d not in victims and 2000 <= years[d] <= 2007])
    _, ref_i = _oracle(q, np.concatenate([emb, new[:4]])[passing], passing, 10)
    np.testing.assert_array_equal(i, ref_i)


def full_search_citation_rerank_with_deletes_and_broad_filter(P):
    emb, new, q = _small()
    rows = _cyclic_years(_meta_rows(600))
    for i, r in enumerate(rows):
        r["citations"] = (i * 7) % 500
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(rows))
    victims = list(range(100, 160))
    eng.delete_documents(victims)
    flt = P.SearchFilters(top_k=10, year_range=(2000, 2007), citation_weight=0.3)
    assert eng.search_pool_k(flt) == 100
    res = eng.search(q[0], filters=flt)
    assert len(res) == 10
    years = np.array([r["year"] for r in rows])
    for r in res:
        assert r["doc_id"] not in victims and 2000 <= years[r["doc_id"]] <= 2007
    key = [r["similarity"] + 0.3 * np.log1p(rows[r["doc_id"]]["citations"]) for r in res]
    assert all(key[i] >= key[i + 1] - 1e-6 for i in range(len(key) - 1))


def add_1d_vector_without_normalize(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    assert list(eng.add_documents(new[0], normalize=False)) == [600]
    assert eng.num_live == 601
    _, i = eng.search_vectors(new[0], k=1)
    assert int(i[0, 0]) == 600


def _bare_meta(P):
    return P.CorpusMetadata.from_rows(
        [{"paper_id": f"p{i}", "paper_title": "T", "authors": [], "link": "", "year": 2020,
          "primary_category": "math.NT", "journal_ref": None, "citations": 0} for i in range(600)])


def update_with_meta_requires_arange_before_mutation(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=_bare_meta(P), ids=np.arange(1000, 1600, dtype=np.int64))
    with pytest.raises(ValueError, match="row-order"):
        eng.update_document(1005, new[0])
    assert eng.num_live == 600
    _, i = eng.search_vectors(emb[5], k=1)
    assert int(i[0, 0]) == 1005


def filtered_search_requires_arange_ids(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=_bare_meta(P), ids=np.arange(1000, 1600, dtype=np.int64))
    with pytest.raises(ValueError, match="row-order"):
        eng.search_vectors(q, k=5, filters=P.SearchFilters(tags=["math.NT"]))
    _, i = eng.search_vectors(q, k=5)
    assert (i >= 1000).all()


def heavily_deleted_corpus_stays_exact(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    assert eng.delete_documents(list(range(540))) == 540
    _, i = eng.search_vectors(q, k=10)
    assert set(i[i >= 0].tolist()) <= set(range(540, 600))
    np.testing.assert_array_equal(i, _oracle(q, emb[540:], np.arange(540, 600), 10)[1])


def overfetch_margin_adapts_to_drop_rate(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    assert eng._overfetch_margin(10, 0.001) == 8
    assert eng._overfetch_margin(10, 0.1) == 16
    assert eng._overfetch_margin(10, 0.5) == 64
    assert eng.delete_documents([5, 6, 7]) == 3
    _, i = eng.search_vectors(q, k=10)
    if not P.torch:
        assert (18, False, 10) in eng._search_fn_cache
    else:
        assert eng.route_counts.get("overfetch") == 1
    keep = np.array(sorted(set(range(600)) - {5, 6, 7}))
    np.testing.assert_array_equal(i, _oracle(q, emb[keep], keep, 10)[1])


def compact_nonblocking_concurrent_latency(P):
    import time

    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    eng.search_vectors(q, k=5)
    eng._compact_pre_swap_hook = lambda: time.sleep(1.5)
    lat, errs, stop = [], [], threading.Event()

    def hammer():
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                _, i = eng.search_vectors(q, k=5)
                assert i.shape == (9, 5)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                return
            lat.append(time.monotonic() - t0)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        eng.add_documents(new[:10], normalize=False)
        t0 = time.monotonic()
        assert eng.compact() == 10
        compact_s = time.monotonic() - t0
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errs, errs
    assert compact_s >= 1.5 and len(lat) >= 5
    assert max(lat) < 0.75 * compact_s, f"a query stalled {max(lat):.2f}s in a {compact_s:.2f}s compact"


def compact_mid_build_mutations(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    ids0 = eng.add_documents(new[:4], normalize=False)
    mid = {}

    def mid_build():
        mid["added"] = eng.add_documents(new[4:8], normalize=False)
        assert eng.delete_documents([ids0[0]]) == 1
        eng.update_document(int(ids0[1]), new[8])
        assert eng.delete_documents([17]) == 1

    eng._compact_pre_swap_hook = mid_build
    assert eng.compact() == 4
    eng._compact_pre_swap_hook = None
    assert eng.n_valid == 604
    _, i = eng.search_vectors(new[4:8], k=1)
    assert i[:, 0].tolist() == [int(x) for x in mid["added"]]
    _, i = eng.search_vectors(new[:1], k=3)
    assert int(ids0[0]) not in i.ravel().tolist()
    _, i = eng.search_vectors(new[8:9], k=1)
    assert int(i[0, 0]) == int(ids0[1])
    _, i = eng.search_vectors(emb[17:18], k=3)
    assert 17 not in i.ravel().tolist()
    assert eng.compact() == 5
    _, i = eng.search_vectors(new[8:9], k=1)
    assert int(i[0, 0]) == int(ids0[1])
    _, i = eng.search_vectors(new[4:8], k=1)
    assert i[:, 0].tolist() == [int(x) for x in mid["added"]]


def engine_ivf_route_survives_compact(P):
    emb, new, q = _small()
    ivf = P.ivf(emb, "small", ivf_nlist=16, dtype="int8", ivf_assign2_margin=0.02)
    idx = P.build(emb, config=P.IndexConfig(pad_multiple=128, dtype="float32"))
    eng = P.engine(idx, True, row_block=128, ivf_index=ivf, ivf_nprobe=8, rescore_factor=8)
    ids = eng.add_documents(new, normalize=False)
    assert eng.compact() == len(ids)
    assert eng.ivf is not None and eng.ivf.num_rows == 620
    _, i = eng.search_vectors(new[:8], k=1)
    assert i[:, 0].tolist() == [int(x) for x in ids[:8]]
    _, i = eng.search_vectors(q, k=10)
    _, ref = _oracle(q, np.concatenate([emb, new]), np.arange(620), 10)
    assert (i[:, :, None] == ref[:, None, :]).any(2).mean() >= 0.9
    if P.torch:
        assert eng.route_counts["ivf"] >= 2
    eng.update_document(int(ids[0]), new[10])
    assert eng.compact() == 1
    _, i = eng.search_vectors(new[10:11], k=2)
    assert int(ids[0]) in i.ravel().tolist()


def compact_reclaim_drops_tombstones(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb, P.CorpusMetadata.from_rows(_meta_rows(600)))
    victims = list(range(0, 600, 10))
    assert eng.delete_documents(victims) == 60
    ids = eng.add_documents(new[:5], meta_rows=_meta_rows(5, start=600), normalize=False)
    n_live = eng.num_live
    assert eng.compact(reclaim=True) == 5
    assert eng.n_valid == 545 and eng.num_live == n_live == 545
    assert eng._tombstone is None and eng._main_ids_arange and len(eng.meta) == 545
    mp = eng.last_id_map
    assert mp is not None and (mp[victims] == -1).all()
    new_id = int(mp[11])
    assert eng.meta.paper_id[new_id] == "p11"
    _, i = eng.search_vectors(emb[11:12], k=1)
    assert int(i[0, 0]) == new_id
    _, i = eng.search_vectors(new[:5], k=1)
    assert i[:, 0].tolist() == [int(mp[x]) for x in ids]
    assert eng._speed_ok
    _, i = eng.search_vectors(q, k=10)
    assert (i >= 0).all()


def compact_reclaim_translates_inflight_ids(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    assert eng.delete_documents(list(range(100))) == 100
    fin = eng.search_vectors_async(q, k=5)
    assert eng.compact(reclaim=True) == 0 and eng.n_valid == 500
    s_old, i_old = fin()
    s_new, i_new = eng.search_vectors(q, k=5)
    np.testing.assert_array_equal(i_old, i_new)
    np.testing.assert_allclose(s_old, s_new, atol=1e-3)


def compact_device_fold_bitexact(P):
    emb, new, q = _small()
    eng = P.speed_engine(emb)
    ids = eng.add_documents(new, normalize=False)
    eng.update_document(5, new[0])
    eng.delete_documents([7, int(ids[2])])
    eng.compact()
    for round_ in range(2):
        fresh = P.engine(eng.index, True, row_block=128, rescore_vectors=eng.rescore_vectors,
                         rescore_factor=8)
        np.testing.assert_array_equal(P.np(eng.vectors), P.np(fresh.vectors))
        assert eng._rescore_device is not None
        np.testing.assert_array_equal(P.np(eng._rescore_device.float()) if P.torch
                                      else np.asarray(eng._rescore_device, np.float32),
                                      P.np(fresh._rescore_device.float()) if P.torch
                                      else np.asarray(fresh._rescore_device, np.float32))
        if round_ == 0:
            eng.add_documents(new[:3], normalize=False)
            eng.compact()
    eng.search_vectors(q, k=10)


def inflight_host_rescore_survives_reclaim_swap(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, rescore_vectors=emb.copy(), rescore_factor=8)
    assert eng.delete_documents(list(range(100))) == 100
    fin = eng.search_vectors_async(q, k=5)
    assert eng.compact(reclaim=True) == 0
    s_old, i_old = fin()
    s_new, i_new = eng.search_vectors(q, k=5)
    np.testing.assert_array_equal(i_old, i_new)
    np.testing.assert_allclose(s_old, s_new, atol=1e-3)


def update_document_meta_survives_reclaim_build(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    assert eng.delete_documents(list(range(50))) == 50
    eng._compact_pre_swap_hook = lambda: eng.update_document(300, new[0], meta_row={"year": 2031})
    try:
        eng.compact(reclaim=True)
    finally:
        eng._compact_pre_swap_hook = None
    nid = int(eng.last_id_map[300])
    assert nid == 250 and int(np.asarray(eng.meta.year)[nid]) == 2031
    _, i = eng.search_vectors(new[:1], k=1)
    assert int(i[0, 0]) == nid


def grouped_filters_survive_compact(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    flist = [None if i % 3 == 0 else P.SearchFilters(year_range=(2010, 2010)) if i % 3 == 1
             else P.SearchFilters(authors=[f"A{i % 7}"]) for i in range(9)]

    def check():
        _, i_g = eng.search_vectors(q, k=6, filters=flist)
        for b in range(9):
            _, i1 = eng.search_vectors(q[b : b + 1], k=6, filters=flist[b])
            assert set(i_g[b].tolist()) == set(i1[0].tolist()), f"q{b}"

    check()
    eng.add_documents(new[:5], meta_rows=_meta_rows(5, 600), normalize=False)
    eng.delete_documents([3, 601])
    check()
    assert eng.compact() == 4
    check()
    eng.compact(reclaim=True)
    check()


def mask_build_counters_survive_compact(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    eng.search_vectors(q[:2], k=4, filters=P.SearchFilters(year_range=(2010, 2010)))
    b0, s0 = eng.filter_mask_builds, eng.filter_mask_build_s
    assert b0 >= 1 and s0 > 0
    eng.add_documents(new[:3], meta_rows=_meta_rows(3, 600), normalize=False)
    assert eng.compact() == 3
    assert eng.filter_mask_builds >= b0 and eng.filter_mask_build_s >= s0


def service_and_http_live_updates(P):
    import json
    import urllib.request

    if P.torch:
        from theoremsearch_tpu_torch.serve.app import SearchService
        from theoremsearch_tpu_torch.serve.http_api import SearchServer
    else:
        from theoremsearch_tpu.serve.app import SearchService
        from theoremsearch_tpu.serve.http_api import SearchServer
    emb, _, q = _small()
    eng = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))

    def encode(texts):
        # one vector per text, from the text alone
        return _norm(np.stack([np.random.default_rng(sum(map(ord, t)) * 7919 + len(t))
                               .standard_normal(64) for t in texts]))

    svc = SearchService(eng.raw, encode)
    n0 = svc.load_theorem_count()
    server = SearchServer(svc).start()

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())

    try:
        url = f"http://127.0.0.1:{server.port}"
        code, out = post("/documents", {"documents": _meta_rows(2, start=600, year=2024)})
        assert code == 200 and out["doc_ids"] == [600, 601]
        health = json.loads(urllib.request.urlopen(url + "/health", timeout=60).read())
        assert health["corpus"] == n0 + 2
        code, res = post("/search", {"query": "slogan 600", "top_k": 3})
        assert code == 200 and len(res["results"]) == 3
        assert res["results"][0]["doc_id"] == 600     # its own slogan's vector
        code, rd = post("/documents/delete", {"doc_ids": [600]})
        assert code == 200 and rd["deleted"] == 1
        health = json.loads(urllib.request.urlopen(url + "/health", timeout=60).read())
        assert health["corpus"] == n0 + 1
        code, res = post("/search", {"query": "slogan 600", "top_k": 3})
        assert code == 200 and 600 not in [r["doc_id"] for r in res["results"]]
    finally:
        server.stop()
    eng.search_vectors(encode(["slogan 601"]), k=3)


def scheduler_concurrent_with_mutations(P):
    emb, new, q = _small()
    eng = P.fp32_engine(emb)
    sched = P.scheduler(eng, max_batch=32, max_wait_ms=5)
    stop, errors = threading.Event(), []

    def mutate():
        try:
            for r in range(6):
                eng.add_documents(new[3 * r : 3 * r + 3], normalize=False)
                eng.delete_documents([r * 40, r * 40 + 1])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    def query(i):
        try:
            while not stop.is_set():
                _, ids = sched.search(q[i % len(q)], k=5)
                assert ids.shape == (5,)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    mt = threading.Thread(target=mutate)
    qs = [threading.Thread(target=query, args=(i,)) for i in range(4)]
    for t in qs:
        t.start()
    mt.start()
    mt.join()
    for t in qs:
        t.join()
    sched.shutdown()
    assert not errors, errors
    assert eng.num_live == 600 + 18 - 12
    _, i = eng.search_vectors(new[:18], k=1)
    assert (i[:, 0] >= 600).all()
    _, i2 = eng.search_vectors(q, k=10)
    dead = {r * 40 for r in range(6)} | {r * 40 + 1 for r in range(6)}
    assert not set(i2.ravel().tolist()) & dead


SCENARIOS = [
    add_documents_searchable_immediately, delete_main_and_delta, update_document_replaces_vector,
    delta_docs_respect_filters_and_join, add_requires_meta_rows_when_meta,
    speed_path_live_updates, compact_folds_delta, update_then_compact_keeps_arange,
    compact_residual_mode, all_main_deleted_serves_from_delta, delta_capacity_growth,
    vector_only_custom_meta_none, compact_after_deleting_lowest_new_id,
    compact_all_delta_deleted_folds_gap, compact_concurrent_with_queries,
    compact_update_then_delete_is_noop, add_with_meta_requires_arange_ids, compact_custom_ids,
    tombstone_overfetch_stays_on_fast_path, tombstone_overfetch_fallback_exact,
    broad_filter_overfetch_matches_masked_path, broad_filter_overfetch_with_tombstones_and_delta,
    full_search_citation_rerank_with_deletes_and_broad_filter, add_1d_vector_without_normalize,
    update_with_meta_requires_arange_before_mutation, filtered_search_requires_arange_ids,
    heavily_deleted_corpus_stays_exact, overfetch_margin_adapts_to_drop_rate,
    compact_nonblocking_concurrent_latency, compact_mid_build_mutations,
    engine_ivf_route_survives_compact, compact_reclaim_drops_tombstones,
    compact_reclaim_translates_inflight_ids, compact_device_fold_bitexact,
    inflight_host_rescore_survives_reclaim_swap, update_document_meta_survives_reclaim_build,
    grouped_filters_survive_compact, mask_build_counters_survive_compact,
    service_and_http_live_updates, scheduler_concurrent_with_mutations,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_live_updates_match_reference(scenario):
    twin(scenario)

