"""Port parity: the filtered and exact routes of the port's SearchEngine
against the JAX SearchEngine (Pallas interpret mode) on one corpus and
one metadata set, laid out like the reference's serving benchmark (years
in contiguous id blocks, categories striped, journal status alternating,
citations i % 1000). Also the fp32 oracle's row mask and the scheduler's
grouped window."""

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
from theoremsearch_tpu_torch.search.filters import SearchFilters, compile_filter_mask
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

torch.set_num_threads(1)

N, D = 4096, 64
CATS = [f"math.{c}" for c in "AG AT AP CA CO CT DG DS FA GM GN GR GT HO KT LO MG NT OA PR RA RT".split()]
NEEDLES = (5, 2222, 4000)          # the only rows a title filter keeps


def _sigs(cls):
    """The serving benchmark's 3- and 36-signature mixes
    (tools/serve_bench.py), built with either package's SearchFilters."""
    three = [cls(year_range=(2005, 2013)), cls(tags=["math.NT", "math.AG", "math.CO"]),
             cls(journal_status="Preprint Only")]
    many = ([cls(year_range=(1996 + j, 2001 + j)) for j in range(16)]
            + [cls(tags=[f"math.{c}"]) for c in ("AG", "NT", "CO", "PR", "CA", "DG", "FA", "GT")]
            + [cls(citation_range=(50 * j, 50 * j + 120)) for j in range(8)]
            + [cls(year_range=(2004, 2015), tags=["math.AG", "math.NT"]),
               cls(journal_status="Journal Article", citation_range=(10, 500)),
               cls(year_range=(2010, 2020), journal_status="Preprint Only"),
               cls(tags=["math.CO"], citation_range=(0, 99))])
    return three, many


NARROW = {
    "years": dict(year_range=(2005, 2013)),                        # contiguous ids
    "category": dict(tags=["math.NT"]),                            # striped
    "three": dict(paper_filter={"ids": set(), "titles": {"needle"}}),
    "citations": dict(citation_range=(0, 99), include_unknown_citations=False),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((24, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # query 23's 80 nearest docs all fail the 50% "Preprint Only" filter
    # (odd rows carry a journal ref): its over-fetch window overflows
    emb[1:161:2] = q[23] + 0.3 * emb[1:161:2]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    block = N // 30
    rows = [
        {"paper_id": f"p{i}", "paper_title": "Needle paper" if i in NEEDLES else f"Paper {i}",
         "link": f"https://stacks.math/{i}" if i % 64 == 1 else "https://arxiv.org/abs/x",
         "year": 1995 + i // block, "primary_category": CATS[i % len(CATS)],
         "journal_ref": None if i % 2 == 0 or i % 64 == 1 else "J. Math.",
         "citations": i % 1000, "theorem_name": "Lemma" if i % 3 else "Theorem",
         "slogan": f"slogan {i}", "theorem_body": f"$x_{i}$"}
        for i in range(N)
    ]
    return emb, q, rows


def _pair(data, cfg, rescore=True, ids=None):
    emb, _, rows = data
    rv = emb if rescore else None
    jeng = JSearchEngine(JFlatIndex.build(emb, ids=ids, config=JIndexConfig(**cfg)),
                         meta=JCorpusMetadata.from_rows(rows), use_pallas=True,
                         pallas_interpret=True, rescore_vectors=rv)
    teng = SearchEngine(FlatIndex.build(emb, ids=ids, config=IndexConfig(**cfg), device="cpu"),
                        meta=CorpusMetadata.from_rows(rows), rescore_vectors=rv, device="cpu")
    assert jeng._speed_ok == teng._speed_ok and jeng.row_block == teng.row_block
    return jeng, teng


@pytest.fixture(scope="module")
def speed(data):
    return _pair(data, dict(dtype="int8", int8_scale="global"))


EXACT_CFGS = {
    "int8_perrow": (dict(dtype="int8"), True),
    "bf16": (dict(dtype="bfloat16"), True),
    "int8_global_no_rescore": (dict(dtype="int8", int8_scale="global"), False),
    "f32_no_rescore": (dict(dtype="float32"), False),
}


@pytest.fixture(scope="module", params=list(EXACT_CFGS))
def exact(request, data):
    cfg, rescore = EXACT_CFGS[request.param]
    return _pair(data, cfg, rescore)


def _routes(monkeypatch, teng):
    """Record the masks each `_speed_search` call of the port got."""
    seen = []
    inner = teng._speed_search

    def spy(q, k_q, base_k, mask=None, gmasks=None, mask_ids=None):
        seen.append("grouped" if gmasks is not None else "masked" if mask is not None else "plain")
        return inner(q, k_q, base_k, mask=mask, gmasks=gmasks, mask_ids=mask_ids)

    monkeypatch.setattr(teng, "_speed_search", spy)
    return seen


def _same(j, t):
    (js, ji), (ts, ti) = j, t
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_filter_masked_route_equals_jax(data, speed, monkeypatch, name):
    _, q, _ = data
    jeng, teng = speed
    seen = _routes(monkeypatch, teng)
    t = teng.search_vectors(q[:16], k=10, filters=SearchFilters(**NARROW[name]))
    _same(jeng.search_vectors(q[:16], k=10, filters=JSearchFilters(**NARROW[name])), t)
    assert seen == ["masked"]
    mask = compile_filter_mask(SearchFilters(**NARROW[name]), teng.meta)
    ok = t[1] >= 0
    assert mask[t[1][ok]].all()
    if name == "three":
        assert (np.sort(t[1][:, :3], axis=1) == sorted(NEEDLES)).all() and not ok[:, 3:].any()


def test_filter_passing_nothing_gives_empty_results(data, speed):
    _, q, _ = data
    jeng, teng = speed
    f = dict(tags=["math.none"])
    _same(jeng.search_vectors(q[:4], k=10, filters=JSearchFilters(**f)),
          teng.search_vectors(q[:4], k=10, filters=SearchFilters(**f)))
    assert (teng.search_vectors(q[:4], k=10, filters=SearchFilters(**f))[1] == -1).all()
    assert teng.search(q[0], SearchFilters(tags=["math.none"])) == []


def test_broad_filter_takes_overfetch_route(data, speed, monkeypatch):
    _, q, _ = data
    jeng, teng = speed
    seen = _routes(monkeypatch, teng)
    f = dict(journal_status="Preprint Only")          # exactly half the rows pass
    _same(jeng.search_vectors(q[:16], k=10, filters=JSearchFilters(**f)),
          teng.search_vectors(q[:16], k=10, filters=SearchFilters(**f)))
    assert seen == ["plain"]                           # k + margin, host drop


def test_overfetch_overflow_reruns_masked(data, speed, monkeypatch):
    _, q, _ = data
    jeng, teng = speed
    seen = _routes(monkeypatch, teng)
    f = dict(journal_status="Preprint Only")
    qq = q[16:24]                                      # holds query 23
    before = dict(teng.route_counts)
    t = teng.search_vectors(qq, k=10, filters=SearchFilters(**f))
    _same(jeng.search_vectors(qq, k=10, filters=JSearchFilters(**f)), t)
    assert seen == ["plain", "masked"]
    delta = {r: n - before.get(r, 0) for r, n in teng.route_counts.items()}
    assert {r: n for r, n in delta.items() if n} == {"overfetch": 1, "overfetch_rerun": 1, "masked": 1}
    assert (t[1] % 2 == 0).all()


@pytest.mark.parametrize("n_sigs", [5, 36])
def test_grouped_dispatch_equals_jax_and_per_signature(data, speed, monkeypatch, n_sigs):
    """Up to 32 signatures run as one grouped scan; 36 split into two."""
    _, q, _ = data
    jeng, teng = speed
    jmany, tmany = _sigs(JSearchFilters)[1], _sigs(SearchFilters)[1]
    qq = np.concatenate([q[:20]] * 2)                  # 40 queries
    pick = [i % n_sigs for i in range(40)]
    # every signature once, then unfiltered rows among the repeats
    tf = [None if i >= n_sigs and i % 2 else tmany[p] for i, p in enumerate(pick)]
    jf = [None if i >= n_sigs and i % 2 else jmany[p] for i, p in enumerate(pick)]
    seen = _routes(monkeypatch, teng)
    t = teng.search_vectors(qq, k=10, filters=tf)
    _same(jeng.search_vectors(qq, k=10, filters=jf), t)
    assert seen == (["grouped"] if n_sigs <= 32 else ["grouped", "grouped"])
    for r in range(0, 40, 9):
        np.testing.assert_array_equal(t[1][r], teng.search_vectors(qq[r], k=10, filters=tf[r])[1][0])


def test_exact_route_equals_jax(data, exact):
    """Per-row int8, bf16 (with host rescore) and global int8 / f32
    without a rescore copy all run on kernel B5, unfiltered, narrow
    (row bias), broad (over-fetch) and grouped (per signature)."""
    _, q, _ = data
    jeng, teng = exact
    assert not teng._speed_ok and not teng.supports_grouped_filters
    _same(jeng.search_vectors(q[:16], k=10), teng.search_vectors(q[:16], k=10))
    for f in (NARROW["years"], NARROW["three"], dict(journal_status="Preprint Only")):
        _same(jeng.search_vectors(q, k=10, filters=JSearchFilters(**f)),
              teng.search_vectors(q, k=10, filters=SearchFilters(**f)))
    jthree, tthree = _sigs(JSearchFilters)[0], _sigs(SearchFilters)[0]
    _same(jeng.search_vectors(q[:9], k=10, filters=[jthree[i % 3] for i in range(9)]),
          teng.search_vectors(q[:9], k=10, filters=[tthree[i % 3] for i in range(9)]))


def test_custom_ids_exact_route_equals_jax(data):
    emb, q, _ = data
    ids = np.random.default_rng(4).permutation(N).astype(np.int64) * 3 + 7
    jeng, teng = _pair(data, dict(dtype="int8"), ids=ids)
    assert not teng._speed_ok
    _same(jeng.search_vectors(q, k=10), teng.search_vectors(q, k=10))
    with pytest.raises(ValueError, match="row-order"):
        teng.search_vectors(q, k=10, filters=SearchFilters(**NARROW["years"]))


def test_filtered_recall_against_masked_oracle(data, speed):
    emb, q, _ = data
    _, teng = speed
    for f in _sigs(SearchFilters)[0] + _sigs(SearchFilters)[1][::5]:
        mask = compile_filter_mask(f, teng.meta)
        _, oracle = exact_topk(q, emb, k=10, chunk_rows=1000, mask=mask, device="cpu")
        _, ids = teng.search_vectors(q, k=10, filters=f)
        assert recall_vs_exact(ids, oracle, k=10) >= 0.99
        assert mask[ids[ids >= 0]].all()


def test_masked_oracle_pads_beyond_passing_rows(data):
    emb, q, _ = data
    mask = np.zeros(N, bool)
    mask[[3, 9]] = True
    s, i = exact_topk(q[:2], emb, k=4, mask=mask, device="cpu")
    assert (np.sort(i[:, :2], axis=1) == [3, 9]).all() and (i[:, 2:] == -1).all()
    assert np.isneginf(s[:, 2:]).all()


@pytest.mark.parametrize("n_req,sigs", [(12, 12), (40, 36)])
def test_scheduler_grouped_window_is_one_scan(data, speed, n_req, sigs):
    """A held window of mixed signatures dispatches as ONE grouped
    dispatch (g = distinct signatures; above 32 the engine splits it into
    two scans, and g per scan says so), with the direct per-query
    results."""
    _, q, _ = data
    _, teng = speed
    many = _sigs(SearchFilters)[1]
    qq = np.concatenate([q, q])[:n_req]
    sched = BatchScheduler(teng, max_batch=64, max_wait_ms=1.0,
                           filter_coalesce_ms=60_000, filter_coalesce_min=n_req)
    try:
        filt = [many[(5 * i) % 36] if sigs == 12 else many[i % 36] for i in range(n_req)]
        futs = [sched.submit(qq[i], k=10, filters=filt[i]) for i in range(n_req)]
        got = [f.result(60) for f in futs]
        st = sched.stats()
    finally:
        sched.shutdown()
    assert len({id(f) for f in filt}) == sigs
    assert st["filtered_batches"] == 1 and st["batches"] == 1
    assert st["filtered_g_mean"] == sigs / (1 if sigs <= 32 else 2)
    for i in range(n_req):
        np.testing.assert_array_equal(got[i][1], teng.search_vectors(qq[i], k=10, filters=filt[i])[1][0])
