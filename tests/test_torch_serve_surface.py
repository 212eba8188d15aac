"""The serving surface twinned on both packages (the cases of
tests/test_http_api.py, tests/test_scheduler.py and tests/test_serve.py
that no other port test holds to the reference): admission control
(max_pending -> SchedulerOverloaded -> HTTP 429) and the scheduler's
/metrics; /health, /facets and /metrics without a scheduler; 400 and
404; /feedback, unsaved without a path and persisted with one, read back
by pairs_from_feedback; the GC freeze at server start and the re-freeze
after compact; the scheduler's mixed k, error propagation, text-encode
errors and the deadline flush of a lone filtered request; SearchService's
UI filter dict, no sources, facets, batch search and feedback. Each case
runs on the reference package and on the port with the same corpus,
metadata and encoder; their answers must agree (scores within 1e-5, ids
wherever a score is unique) and the port's must pass the reference
test's own checks."""

import gc
import hashlib
import importlib
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_helpers import ids_agree

torch.set_num_threads(1)


class Pkg:
    """One package's serving names, and engines built its tests' way."""

    def __init__(self, name: str):
        self.torch = name == "torch"
        root = "theoremsearch_tpu_torch" if self.torch else "theoremsearch_tpu"

        def m(rel):
            return importlib.import_module(f"{root}.{rel}")

        self.IndexConfig = m("core.config").IndexConfig
        self.CorpusMetadata = m("search.metadata").CorpusMetadata
        self.SearchFilters = m("search.filters").SearchFilters
        self.SearchService = m("serve.app").SearchService
        self.SearchServer = m("serve.http_api").SearchServer
        self.BatchScheduler = m("serve.scheduler").BatchScheduler
        self.SchedulerOverloaded = m("serve.scheduler").SchedulerOverloaded
        self.pairs_from_feedback = m("train.data").pairs_from_feedback
        self.freeze_permanent = m("utils.gc_tuning").freeze_permanent
        self._flat = m("index.flat").FlatIndex
        self._engine = m("search.engine").SearchEngine

    def engine(self, emb, config, meta=None, normalize=True, row_block=128):
        if self.torch:
            idx = self._flat.build(emb, config=config, normalize=normalize, device="cpu")
            return self._engine(idx, meta=meta, row_block=row_block, device="cpu")
        idx = self._flat.build(emb, config=config, normalize=normalize)
        return self._engine(idx, meta=meta, use_pallas=False, row_block=row_block)


def twin(case, *args):
    """`case(pkg, *args)` on both packages; returns (reference's, port's)."""
    return tuple(case(Pkg(name), *args) for name in ("jax", "torch"))


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)).astype(np.float32)


def hash_encoder(d):
    """A bag-of-words md5 encoder (the reference tests': builtin hash()
    is salted per process)."""
    def encode(texts):
        out = np.zeros((len(texts), d), np.float32)
        for i, t in enumerate(texts):
            for tok in t.lower().split():
                out[i, int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little") % d] += 1.0
        return _unit(out)
    return encode


def _rows_agree(want, got, where=""):
    """Two search_and_display answers: the same length, scores within
    1e-5, doc ids equal wherever the score is unique."""
    assert len(got) == len(want), where
    if not want:
        return
    s = [np.array([[r["score"] for r in rows]], np.float32) for rows in (want, got)]
    i = [np.array([[r["doc_id"] for r in rows]]) for rows in (want, got)]
    ids_agree(s[0], i[0], s[1], i[1], where=where)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _post(port, path, payload=None, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# ------------------------------------------------------------------ HTTP

N_HTTP, D_HTTP = 300, 128
BODIES = [f"statement about subject {i % 30}" for i in range(N_HTTP)]


def _http_rows():
    return [{"paper_id": f"p{i}", "paper_title": f"Title {i}", "authors": [f"A{i % 5}"],
             "link": "https://arxiv.org/abs/x", "year": 2020, "primary_category": "math.NT",
             "journal_ref": None, "citations": i, "theorem_name": "Theorem 1.",
             "theorem_body": BODIES[i], "slogan": f"slogan {i}"} for i in range(N_HTTP)]


def test_http_routes_twin():
    """/health, /facets, /metrics without a scheduler, /search with and
    without filters, 400 on a bad body, 404 on an unknown path, and
    /feedback unsaved without a feedback path (400 on a bad vote)."""
    encode = hash_encoder(D_HTTP)

    def case(p):
        eng = p.engine(encode(BODIES), p.IndexConfig(pad_multiple=128),
                       meta=p.CorpusMetadata.from_rows(_http_rows()))
        srv = p.SearchServer(p.SearchService(eng, encode)).start()
        try:
            port = srv.port
            health, facets, metrics = (_get(port, path) for path in ("/health", "/facets", "/metrics"))
            search = _post(port, "/search", {"query": "subject 7", "top_k": 4})
            filtered = _post(port, "/search", {"query": "subject 3", "top_k": 5,
                                               "filters": {"authors": ["A2"], "citation_weight": 0.1}})
            bad = _post(port, "/search", raw=b"{not json")
            nope = _get(port, "/nope")
            fb = _post(port, "/feedback", {"feedback": "up", "query": "prime gaps",
                                           "url": "https://arxiv.org/abs/1", "theorem_name": "Theorem 1"})
            fb_bad = _post(port, "/feedback", {"feedback": "meh"})
        finally:
            srv.stop()
            gc.unfreeze()
        return health, facets, metrics, search, filtered, bad[0], nope[0], fb, fb_bad[0]

    ref, got = twin(case)
    health, facets, metrics, search, filtered, bad, nope, fb, fb_bad = got
    assert health[0] == 200 and json.loads(health[2]) == json.loads(ref[0][2]) == {
        "status": "ok", "corpus": 300}
    assert facets[0] == 200 and json.loads(facets[2]) == json.loads(ref[1][2])
    assert len(json.loads(facets[2])["authors"]) == 5
    assert metrics[0] == 200 and "theoremsearch_corpus_rows 300" in metrics[2]
    assert "theoremsearch_requests_total" not in metrics[2]
    assert metrics[2].splitlines() == ref[2][2].splitlines()
    for (code, body), (rcode, rbody), n in ((search, ref[3], 4), (filtered, ref[4], 5)):
        assert code == rcode == 200 and len(body["results"]) == len(rbody["results"])
        _rows_agree(rbody["results"], body["results"])
        assert all("display_markdown" in r and "similarity" in r for r in body["results"])
    assert len(search[1]["results"]) == 4 and "subject 7" in search[1]["results"][0]["theorem_body"]
    assert filtered[1]["results"] and all("A2" in r["authors"] for r in filtered[1]["results"])
    assert (bad, nope, fb_bad) == (ref[5], ref[6], ref[8]) == (400, 404, 400)
    assert fb == ref[7] and fb[0] == 200 and fb[1]["saved"] is False


def test_admission_control_and_scheduler_metrics_twin():
    """SearchService over a BatchScheduler answers as the direct service
    does (citation-weighted rerank included); a scheduler at max_pending
    sheds: submit raises SchedulerOverloaded and POST /search gets 429,
    counted as shed; /metrics then serves the scheduler's counters as
    Prometheus text."""
    emb = _unit(np.random.default_rng(5).standard_normal((512, 32)).astype(np.float32))
    rows = [{"paper_id": f"p{i}", "paper_title": f"T{i}", "authors": [],
             "link": "https://arxiv.org/abs/x", "year": 2020, "primary_category": "math.NT",
             "journal_ref": None, "citations": (i * 7) % 50, "theorem_name": "Theorem 1.",
             "theorem_body": "$x$", "slogan": f"slogan {i}"} for i in range(512)]

    def encode(texts):
        return np.stack([emb[int(t)] for t in texts])

    def case(p):
        eng = p.engine(emb, p.IndexConfig(pad_multiple=128), meta=p.CorpusMetadata.from_rows(rows),
                       normalize=False)
        sched = p.BatchScheduler(eng, max_batch=8, max_wait_ms=5, encode_fn=encode)
        f = p.SearchFilters(top_k=5, citation_weight=0.3)
        routed = p.SearchService(eng, encode, scheduler=sched).search_and_display("17", f)
        direct = p.SearchService(eng, encode).search_and_display("17", f)
        tiny = p.BatchScheduler(eng, max_batch=8, max_wait_ms=5000, encode_fn=encode, max_pending=2)
        srv = p.SearchServer(p.SearchService(eng, encode, scheduler=tiny)).start()
        try:
            raised = 0
            for _ in range(4):
                try:
                    tiny.submit(emb[0], k=5)
                except p.SchedulerOverloaded:
                    raised += 1
            code, _ = _post(srv.port, "/search", {"query": "3", "top_k": 5})
            shed = tiny.stats()["shed"]
            _, ctype, text = _get(srv.port, "/metrics")
        finally:
            srv.stop()
            gc.unfreeze()
            tiny.shutdown()
            sched.shutdown()
        return routed, direct, raised, code, shed, ctype, text

    ref, got = twin(case)
    routed, direct, raised, code, shed, ctype, text = got
    assert [r["doc_id"] for r in routed] == [r["doc_id"] for r in direct]
    assert routed[0]["doc_id"] is not None
    _rows_agree(ref[0], routed)
    assert (raised, code) == (ref[2], ref[3]) == (2, 429) and shed == ref[4] >= 1
    assert ctype.startswith("text/plain") and ref[5].startswith("text/plain")
    for line in ("theoremsearch_corpus_rows 512", "theoremsearch_shed_total", "theoremsearch_inflight"):
        assert line in text and line in ref[6]
    names = [{ln.split()[0] for ln in t.splitlines() if ln and not ln.startswith("#")}
             for t in (ref[6], text)]
    assert names[0] == names[1]


def test_feedback_persists_and_trains_twin(tmp_path):
    """POST /feedback with a feedback path: saved, the record on disk,
    and pairs_from_feedback reads the (query, text) pair back."""
    emb = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)

    def case(p):
        eng = p.engine(emb, p.IndexConfig(dim=16, pad_multiple=16), row_block=16)
        fb = tmp_path / f"{'torch' if p.torch else 'jax'}.jsonl"
        srv = p.SearchServer(p.SearchService(eng, lambda t: emb[: len(t)], feedback_path=str(fb))).start()
        try:
            code, body = _post(srv.port, "/feedback", {
                "feedback": "up", "query": "q", "url": "u", "theorem_name": "Theorem 1.",
                "text": "primes are infinite"})
        finally:
            srv.stop()
            gc.unfreeze()
        rec = json.loads(fb.read_text().strip())
        return code, body, {k: v for k, v in rec.items() if k not in ("ts", "time")}, \
            p.pairs_from_feedback(fb)

    ref, got = twin(case)
    assert got == ref
    code, body, rec, pairs = got
    assert code == 200 and body["saved"] is True and rec["text"] == "primes are infinite"
    assert pairs == [("q", "primes are infinite")]


def test_gc_freeze_at_start_and_after_compact_twin():
    """SearchServer.start() freezes the permanent object graph (collection
    stays on, freezing again is idempotent); compact() re-freezes the new
    host arrays in a process that opted in, and leaves a process that
    never froze alone."""
    def case(p):
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((128, 16)).astype(np.float32)

        def make():
            eng = p.engine(emb, p.IndexConfig(dim=16, pad_multiple=16), row_block=16)
            eng.add_documents(rng.standard_normal((4, 16)).astype(np.float32))
            return eng

        gc.unfreeze()
        try:
            eng = make()
            srv = p.SearchServer(p.SearchService(eng, lambda t: emb[: len(t)]))
            before = gc.get_freeze_count()
            srv.start()
            started = gc.get_freeze_count() > before and gc.isenabled()
            srv.stop()
            again = p.freeze_permanent()["frozen"] >= 0
            gc.unfreeze()
            compacted = make().compact()
            untouched = gc.get_freeze_count() == 0
            p.freeze_permanent()
            n0 = gc.get_freeze_count()
            compacted2 = make().compact()
            refrozen = gc.get_freeze_count() > n0
        finally:
            gc.unfreeze()
        return started, again, compacted, untouched, compacted2, refrozen

    ref, got = twin(case)
    assert got == ref == (True, True, 4, True, 4, True)


# ------------------------------------------------------------- scheduler

N_SCHED, D_SCHED = 2000, 64
EMB_SCHED = _unit(np.random.default_rng(0).standard_normal((N_SCHED, D_SCHED)).astype(np.float32))


def _sched_engine(p):
    rows = [{"paper_id": f"p{i}", "paper_title": f"T{i}", "authors": [],
             "link": "https://arxiv.org/abs/x", "year": 2020,
             "primary_category": "math.AG" if i % 2 else "math.NT", "journal_ref": None,
             "citations": i, "theorem_name": "Theorem 1.", "theorem_body": "b", "slogan": "s"}
            for i in range(N_SCHED)]
    return p.engine(EMB_SCHED, p.IndexConfig(pad_multiple=256, dtype="float32"),
                    meta=p.CorpusMetadata.from_rows(rows), normalize=False)


def test_scheduler_mixed_k_and_errors_twin():
    """Mixed k in one batch; a wrong-dimension query fails its own future
    and the scheduler lives on; submit_text without encode_fn raises; an
    encode_fn that raises fails the text requests while a vector request
    in the same batch resolves."""
    q = _unit(np.random.default_rng(3).standard_normal((2, D_SCHED)).astype(np.float32))

    def case(p):
        eng = _sched_engine(p)
        out = {}
        sched = p.BatchScheduler(eng, max_batch=8, max_wait_ms=40)
        f1, f2 = sched.submit(q[0], k=3), sched.submit(q[1], k=7)
        out["mixed"] = [f1.result(10), f2.result(10)]
        bad = sched.submit(np.zeros(17, np.float32), k=5)
        with pytest.raises(Exception):
            bad.result(10)
        out["alive"] = sched.search(np.zeros(D_SCHED, np.float32), k=2)[1].shape
        with pytest.raises(ValueError):
            sched.submit_text("hello", k=3)
        sched.shutdown()

        def boom(texts):
            raise RuntimeError("tokenizer exploded")

        sched = p.BatchScheduler(eng, max_batch=4, max_wait_ms=10, encode_fn=boom)
        fut = sched.submit_text("q", k=3)
        with pytest.raises(RuntimeError):
            fut.result(10)
        out["vector_after_encode_error"] = sched.submit(np.zeros(D_SCHED, np.float32), k=2).result(10)[1].shape
        sched.shutdown()
        return out

    ref, got = twin(case)
    assert [i.shape for _, i in got["mixed"]] == [(3,), (7,)]
    for (ws, wi), (s, i) in zip(ref["mixed"], got["mixed"]):
        ids_agree(ws[None], wi[None], s[None], i[None])
    assert got["alive"] == ref["alive"] == (2,)
    assert got["vector_after_encode_error"] == ref["vector_after_encode_error"] == (2,)


def test_scheduler_deadline_flush_of_a_lone_filtered_request_twin():
    """Eight same-signature filtered requests coalesce into few scans, each
    finding itself first; a lone filtered request flushes at the coalesce
    deadline, well before the minimum count arrives."""
    def case(p):
        eng = _sched_engine(p)
        sched = p.BatchScheduler(eng, max_batch=64, max_wait_ms=5, filter_coalesce_ms=120.0,
                                 filter_coalesce_min=8)
        f = p.SearchFilters(tags=["math.AG"])
        b0 = sched.stats()["batches"]
        futs = [sched.submit(EMB_SCHED[2 * i + 1], k=5, filters=f) for i in range(8)]
        got = [fu.result(10) for fu in futs]
        scans = sched.stats()["batches"] - b0
        t0 = time.time()
        lone = sched.submit(EMB_SCHED[3], k=5, filters=f).result(10)
        waited = time.time() - t0
        sched.shutdown()
        return got, scans, lone, waited

    ref, got = twin(case)
    res, scans, lone, waited = got
    for i, ((s, ids), (ws, wi)) in enumerate(zip(res, ref[0])):
        assert ids[0] == 2 * i + 1
        ids_agree(ws[None], wi[None], s[None], ids[None])
    assert scans <= 3 and ref[1] <= 3
    assert lone[1][0] == ref[2][1][0] == 3 and waited < 5.0 and ref[3] < 5.0


# --------------------------------------------------------- SearchService

N_SVC, D_SVC = 500, 256
SVC_BODIES = [f"Theorem body about topic {i % 40} with $x_{i}$" for i in range(N_SVC)]


def _svc_rows():
    return [{"paper_id": f"24{i:05d}", "paper_title": f"Title {i}", "authors": [f"Author {i % 9}"],
             "link": "https://arxiv.org/abs/x" if i % 3 else "https://stacks.math.columbia.edu/tag/x",
             "year": 2015 + i % 10, "primary_category": "math.CO",
             "journal_ref": "J" if i % 2 else None, "citations": i, "theorem_name": f"Theorem {i}.",
             "theorem_body": SVC_BODIES[i], "slogan": f"slogan {i}"} for i in range(N_SVC)]


def test_search_service_twin(tmp_path):
    """search_and_display with a UI filter dict (sources, top_k,
    citation_weight), no sources, the facets, search_batch and a saved
    vote."""
    encode = hash_encoder(D_SVC)

    def case(p):
        eng = p.engine(encode(SVC_BODIES), p.IndexConfig(pad_multiple=128),
                       meta=p.CorpusMetadata.from_rows(_svc_rows()))
        fb = tmp_path / f"{'torch' if p.torch else 'jax'}.jsonl"
        svc = p.SearchService(eng, encode, feedback_path=str(fb))
        out = {"plain": svc.search_and_display("topic 7", {"top_k": 5}),
               "ui": svc.search_and_display("topic 3", {"sources": ["Stacks Project"], "top_k": 4,
                                                        "citation_weight": 0.2}),
               "none": svc.search_and_display("x", {"sources": []}),
               "count": svc.load_theorem_count(), "authors": svc.load_authors(),
               "tags": svc.load_tags_per_source(),
               "batch": svc.search_batch(["topic 1", "topic 2", "topic 3"], k=7)}
        svc.save_feedback("up", "my query", "http://x", "Theorem 1.")
        rec = json.loads(fb.read_text().splitlines()[-1])
        out["feedback"] = {k: v for k, v in rec.items() if k not in ("ts", "time")}
        return out

    ref, got = twin(case)
    for key in ("plain", "ui"):
        _rows_agree(ref[key], got[key], key)
    plain, ui = got["plain"], got["ui"]
    assert len(plain) == 5 and all("display_markdown" in r for r in plain)
    assert plain[0]["similarity"] >= plain[-1]["similarity"] and "topic 7" in plain[0]["theorem_body"]
    assert ui and all(r["source"] == "Stacks Project" for r in ui)
    assert all(ui[i]["score"] >= ui[i + 1]["score"] for i in range(len(ui) - 1))
    assert got["none"] == ref["none"] == []
    assert got["count"] == ref["count"] == 500
    assert got["authors"] == ref["authors"] and len(got["authors"]) == 9
    assert got["tags"] == ref["tags"] and {"arXiv", "Stacks Project"} <= set(got["tags"])
    (s, i), (ws, wi) = got["batch"], ref["batch"]
    assert s.shape == i.shape == (3, 7)
    ids_agree(np.asarray(ws), np.asarray(wi), s, i)
    assert got["feedback"] == ref["feedback"]
    assert got["feedback"]["feedback"] == "up" and got["feedback"]["query"] == "my query"
