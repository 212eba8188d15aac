"""Port parity: randomized interleavings of live updates against the JAX
engine, twins of tests/test_live_updates.py's randomized single-device
cases (add / update / delete / compact / reclaim against a host dict
oracle, with filters, the speed path, the IVF route and the scheduler).
Each case runs through `test_torch_live_updates.twin`: once per package,
their logged searches held to each other (ids equal where scores are
unique, scores within 1e-5) and each to the f32 oracle over the live
rows."""

import threading

import numpy as np
import pytest
import torch
from test_torch_live_updates import _meta_rows, _norm, twin

torch.set_num_threads(2)


def _check_topk_vs_oracle(eng, oracle: dict, queries, k, atol=2.5e-3):
    live_ids = np.fromiter(oracle.keys(), np.int64)
    live_vecs = np.stack([oracle[i] for i in live_ids])
    kk = min(k, len(live_ids))
    s, i = eng.search_vectors(queries, k=kk)
    ref = queries @ live_vecs.T
    kth_best = np.sort(ref, axis=1)[:, -kk]
    pos = {int(d): r for r, d in enumerate(live_ids)}
    for b in range(queries.shape[0]):
        rows = [pos.get(int(d), -1) for d in i[b]]
        assert -1 not in rows, f"dead/unknown id returned: {i[b]}"
        assert len({int(d) for d in i[b]}) == kk, f"duplicate ids: {i[b]}"
        got = ref[b, rows]
        np.testing.assert_allclose(s[b], got, atol=atol)
        assert (got >= kth_best[b] - atol).all(), f"rank violation: {got} vs kth {kth_best[b]}"


def _random_op(rng, eng, oracle, dim, p_compact=0.08):
    r = rng.random() * (1.0 if p_compact else 0.92)
    live = list(oracle.keys())
    if not p_compact and r >= 0.60 and len(live) <= 12:
        return "noop"
    if r < 0.40:
        m = int(rng.integers(1, 5))
        vecs = _norm(rng.standard_normal((m, dim)).astype(np.float32))
        for j, d in enumerate(eng.add_documents(vecs, normalize=False)):
            oracle[int(d)] = vecs[j]
        return f"add{m}"
    if r < 0.60 and live:
        d = int(live[rng.integers(len(live))])
        v = _norm(rng.standard_normal((dim,)).astype(np.float32))
        eng.update_document(d, v)
        oracle[d] = v
        return "update"
    if r < 0.92 and len(live) > 12:
        m = int(rng.integers(1, 7))
        picks = rng.choice(live, size=m, replace=False)
        assert eng.delete_documents(picks) == m
        for d in picks:
            oracle.pop(int(d))
        return f"del{m}"
    reclaim = rng.random() < 0.5
    eng.compact(reclaim=reclaim)
    if reclaim and eng.last_id_map is not None:
        mp = eng.last_id_map
        remapped = {}
        for old, vec in oracle.items():
            nid = int(mp[old]) if old < len(mp) else int(old)
            assert nid >= 0, f"live doc {old} dropped by reclaim"
            remapped[nid] = vec
        oracle.clear()
        oracle.update(remapped)
    return "reclaim" if reclaim else "compact"


def randomized_live_ops_vs_oracle(P, seed):
    dim, n0 = 32, 96
    rng = np.random.default_rng(100 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    eng = P.fp32_engine(base)
    oracle = {i: base[i] for i in range(n0)}
    qs = _norm(rng.standard_normal((3, dim)))
    trail = []
    for _ in range(28):
        trail.append(_random_op(rng, eng, oracle, dim))
        assert eng.num_live == len(oracle), f"after {trail}"
        _check_topk_vs_oracle(eng, oracle, qs, k=8)
    eng.compact(reclaim=True)
    mp = eng.last_id_map
    if mp is not None:
        oracle = {(int(mp[d]) if d < len(mp) else d): v for d, v in oracle.items()}
    assert eng.num_live == len(oracle)
    _check_topk_vs_oracle(eng, oracle, qs, k=8)


def randomized_mid_build_mutations_vs_oracle(P, seed):
    dim, n0 = 32, 96
    rng = np.random.default_rng(200 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    eng = P.fp32_engine(base)
    oracle = {i: base[i] for i in range(n0)}
    qs = _norm(rng.standard_normal((3, dim)))
    for _ in range(6):
        _random_op(rng, eng, oracle, dim, p_compact=0.0)

    def mid_build():
        for _ in range(4):
            _random_op(rng, eng, oracle, dim, p_compact=0.0)

    eng._compact_pre_swap_hook = mid_build
    try:
        eng.compact()
    finally:
        eng._compact_pre_swap_hook = None
    assert eng.num_live == len(oracle)
    _check_topk_vs_oracle(eng, oracle, qs, k=8)
    eng.compact()
    _check_topk_vs_oracle(eng, oracle, qs, k=8)


def randomized_live_ops_speed_path(P, seed):
    dim, n0 = 32, 96
    rng = np.random.default_rng(300 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    eng = P.speed_engine(base)
    oracle = {i: base[i] for i in range(n0)}
    qs = _norm(rng.standard_normal((3, dim)))
    for step in range(12):
        _random_op(rng, eng, oracle, dim)
        assert eng.num_live == len(oracle)
        live_ids = np.fromiter(oracle.keys(), np.int64)
        live_vecs = np.stack([oracle[i] for i in live_ids])
        kk = min(8, len(live_ids))
        _, i = eng.search_vectors(qs, k=kk)
        ref = qs @ live_vecs.T
        kth_best = np.sort(ref, axis=1)[:, -kk]
        pos = {int(d): r for r, d in enumerate(live_ids)}
        for b in range(qs.shape[0]):
            rows = [pos.get(int(d), -1) for d in i[b]]
            assert -1 not in rows, f"dead/unknown id returned: {i[b]}"
            assert len({int(d) for d in i[b]}) == kk, f"duplicate ids: {i[b]}"
            assert (ref[b, rows] >= kth_best[b] - 2.5e-3).sum() / kk >= 0.9, f"step {step}"


def randomized_live_ops_with_meta_and_filters(P, seed):
    dim, n0 = 32, 80
    rng = np.random.default_rng(400 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    years = list(2000 + rng.integers(0, 20, size=n0))
    meta_rows = _meta_rows(n0)
    for r, y in zip(meta_rows, years):
        r["year"] = int(y)
    eng = P.fp32_engine(base, meta=P.CorpusMetadata.from_rows(meta_rows))
    oracle = {i: (base[i], int(years[i])) for i in range(n0)}
    qs = _norm(rng.standard_normal((2, dim)))

    def rand_meta(i):
        return dict(_meta_rows(1, start=i)[0], year=int(2000 + rng.integers(0, 20)))

    for step in range(20):
        r = rng.random()
        live = list(oracle.keys())
        if r < 0.35:
            m = int(rng.integers(1, 4))
            vecs = _norm(rng.standard_normal((m, dim)).astype(np.float32))
            rows = [rand_meta(0) for _ in range(m)]
            for j, d in enumerate(eng.add_documents(vecs, meta_rows=rows, normalize=False)):
                oracle[int(d)] = (vecs[j], int(rows[j]["year"]))
        elif r < 0.55 and live:
            d = int(live[rng.integers(len(live))])
            v = _norm(rng.standard_normal((dim,)).astype(np.float32))
            nr = rand_meta(d)
            eng.update_document(d, v, meta_row={"year": nr["year"]})
            oracle[d] = (v, int(nr["year"]))
        elif r < 0.85 and len(live) > 10:
            m = int(rng.integers(1, 5))
            picks = rng.choice(live, size=m, replace=False)
            assert eng.delete_documents(picks) == m
            for d in picks:
                oracle.pop(int(d))
        else:
            reclaim = rng.random() < 0.5
            eng.compact(reclaim=reclaim)
            if reclaim and eng.last_id_map is not None:
                mp = eng.last_id_map
                oracle = {(int(mp[d]) if d < len(mp) else d): v for d, v in oracle.items()}
        assert eng.num_live == len(oracle)
        lo = int(2000 + rng.integers(0, 15))
        passing = {d: v for d, (v, y) in oracle.items() if lo <= y <= lo + 5}
        s, i = eng.search_vectors(qs, k=6, filters=P.SearchFilters(year_range=(lo, lo + 5)))
        if not passing:
            continue
        live_ids = np.fromiter(passing.keys(), np.int64)
        live_vecs = np.stack([passing[d] for d in live_ids])
        kk = min(6, len(live_ids))
        ref = qs @ live_vecs.T
        kth = np.sort(ref, axis=1)[:, -kk]
        pos = {int(d): r2 for r2, d in enumerate(live_ids)}
        for b in range(qs.shape[0]):
            got_ids = [int(d) for d in i[b] if d >= 0][:kk]
            assert len(got_ids) == kk, f"step {step}: {i[b]} vs {kk} passing"
            rows2 = [pos.get(d, -1) for d in got_ids]
            assert -1 not in rows2 and len(set(got_ids)) == kk, f"step {step}: {got_ids}"
            gotv = ref[b, rows2]
            np.testing.assert_allclose(np.asarray(s[b])[: len(gotv)], gotv, atol=2.5e-3)
            assert (gotv >= kth[b] - 2.5e-3).all()
        d0 = int(live_ids[0])
        assert int(np.asarray(eng.meta.year)[d0]) == oracle[d0][1]


def randomized_live_ops_ivf_route(P, seed):
    dim, n0 = 64, 512
    rng = np.random.default_rng(500 + seed)
    centers = _norm(rng.standard_normal((16, dim)).astype(np.float32))
    base = _norm(centers[rng.integers(0, 16, n0)]
                 + (0.5 / np.sqrt(dim)) * rng.standard_normal((n0, dim)).astype(np.float32))
    ivf = P.ivf(base, f"rand{seed}", ivf_nlist=16, dtype="int8", ivf_assign2_margin=0.02)
    idx = P.build(base, config=P.IndexConfig(pad_multiple=128, dtype="float32"))
    eng = P.engine(idx, True, row_block=128, ivf_index=ivf, ivf_nprobe=8, rescore_factor=8)
    oracle = {i: base[i] for i in range(n0)}

    def new_vec(m=1):
        return _norm(centers[rng.integers(0, 16, m)]
                     + (0.5 / np.sqrt(dim)) * rng.standard_normal((m, dim)).astype(np.float32))

    for step in range(10):
        r = rng.random()
        live = list(oracle.keys())
        if r < 0.35:
            vecs = new_vec(int(rng.integers(1, 4)))
            for j, d in enumerate(eng.add_documents(vecs, normalize=False)):
                oracle[int(d)] = vecs[j]
        elif r < 0.55 and live:
            d = int(live[rng.integers(len(live))])
            v = new_vec(1)[0]
            eng.update_document(d, v)
            oracle[d] = v
        elif r < 0.80 and len(live) > 20:
            picks = rng.choice(live, size=int(rng.integers(1, 6)), replace=False)
            assert eng.delete_documents(picks) == len(picks)
            for d in picks:
                oracle.pop(int(d))
        else:
            eng.compact()
            assert eng.ivf is not None, f"IVF route lost at step {step}"
        assert eng.num_live == len(oracle)
        live_ids = np.fromiter(oracle.keys(), np.int64)
        live_vecs = np.stack([oracle[i] for i in live_ids])
        qs = new_vec(4)
        kk = min(8, len(live_ids))
        _, i = eng.search_vectors(qs, k=kk)
        ref = qs @ live_vecs.T
        kth = np.sort(ref, axis=1)[:, -kk]
        pos = {int(d): r2 for r2, d in enumerate(live_ids)}
        hits = 0
        for b in range(qs.shape[0]):
            rows = [pos.get(int(d), -1) for d in i[b]]
            assert -1 not in rows and len({int(d) for d in i[b]}) == kk, f"step {step}: {i[b]}"
            hits += (ref[b, rows] >= kth[b] - 2.5e-3).sum()
        assert hits / (4 * kk) >= 0.85, f"IVF recall {hits}/{4 * kk} at step {step}"
    eng.compact()
    assert eng.ivf is not None and eng.ivf.num_rows >= len(oracle)


def randomized_scheduler_stress_with_compacts(P, seed):
    dim, n0 = 32, 128
    rng = np.random.default_rng(600 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    meta_rows = _meta_rows(n0)
    for j, r in enumerate(meta_rows):
        r["year"] = int(2000 + (j % 20))
    eng = P.fp32_engine(base, meta=P.CorpusMetadata.from_rows(meta_rows))
    oracle = {i: (base[i], 2000 + (i % 20)) for i in range(n0)}
    olock = threading.Lock()
    minted = [n0]
    qs = _norm(rng.standard_normal((8, dim)))
    stop, errors = threading.Event(), []
    sched = P.scheduler(eng, max_batch=16, max_wait_ms=3)

    def mutate():
        mrng = np.random.default_rng(1600 + seed)
        try:
            for _ in range(24):
                r = mrng.random()
                with olock:
                    live = list(oracle.keys())
                if r < 0.4:
                    m = int(mrng.integers(1, 4))
                    vecs = _norm(mrng.standard_normal((m, dim)))
                    rows = _meta_rows(m, start=minted[0])
                    for rr in rows:
                        rr["year"] = int(2000 + mrng.integers(0, 20))
                    ids = eng.add_documents(vecs, meta_rows=rows, normalize=False)
                    with olock:
                        for j, d in enumerate(ids):
                            oracle[int(d)] = (vecs[j], rows[j]["year"])
                        minted[0] = max(minted[0], int(ids[-1]) + 1)
                elif r < 0.6 and live:
                    d = int(live[mrng.integers(len(live))])
                    v = _norm(mrng.standard_normal((dim,)))
                    y = int(2000 + mrng.integers(0, 20))
                    eng.update_document(d, v, meta_row={"year": y})
                    with olock:
                        oracle[d] = (v, y)
                elif r < 0.85 and len(live) > 16:
                    picks = [int(x) for x in mrng.choice(live, size=int(mrng.integers(1, 5)),
                                                         replace=False)]
                    eng.delete_documents(picks)
                    with olock:
                        for d in picks:
                            oracle.pop(d, None)
                else:
                    eng.compact()
        except Exception as e:  # noqa: BLE001
            errors.append(("mutate", e))
        finally:
            stop.set()

    def query(ti):
        qrng = np.random.default_rng(2600 + 10 * seed + ti)
        try:
            while not stop.is_set():
                k = int(qrng.integers(3, 9))
                f = None
                if qrng.random() < 0.5:
                    lo = int(2000 + qrng.integers(0, 15))
                    f = P.SearchFilters(year_range=(lo, lo + 6))
                s, ids = sched.search(qs[ti % len(qs)], k=k, filters=f, timeout=30.0)
                assert ids.shape == (k,)
                s = np.asarray(s, np.float64)
                real = ids >= 0
                assert np.isfinite(s[real]).all() and (np.diff(s[real]) <= 1e-6).all(), s
                assert (ids[real] < minted[0] + 8).all(), f"id beyond minted range: {ids}"
        except Exception as e:  # noqa: BLE001
            errors.append((f"query{ti}", e))

    threads = [threading.Thread(target=query, args=(i,)) for i in range(4)]
    mt = threading.Thread(target=mutate)
    for t in threads:
        t.start()
    mt.start()
    mt.join()
    for t in threads:
        t.join()
    sched.shutdown()
    assert not errors, errors
    with olock:
        vec_oracle = {d: v for d, (v, _y) in oracle.items()}
    assert eng.num_live == len(vec_oracle)
    _check_topk_vs_oracle(eng, vec_oracle, qs[:3], k=8)


RANDOMIZED = [(randomized_live_ops_vs_oracle, s) for s in (0, 1, 2)] + [
    (randomized_mid_build_mutations_vs_oracle, 0), (randomized_mid_build_mutations_vs_oracle, 1),
    (randomized_live_ops_speed_path, 0), (randomized_live_ops_speed_path, 1),
    (randomized_live_ops_with_meta_and_filters, 0), (randomized_live_ops_with_meta_and_filters, 1),
    (randomized_live_ops_ivf_route, 0), (randomized_live_ops_ivf_route, 1),
    (randomized_scheduler_stress_with_compacts, 0),
]


@pytest.mark.parametrize("scenario,seed", RANDOMIZED,
                         ids=[f"{f.__name__}-{s}" for f, s in RANDOMIZED])
def test_randomized_live_ops_match_reference(scenario, seed):
    twin(scenario, seed)
