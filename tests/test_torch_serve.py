"""The port's serving stack on the CPU: BatchScheduler + SearchService +
SearchServer (HTTP) over the speed-path engine and the batched encoder.
Served ids must equal the port's direct (unbatched) path."""

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import init_params
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
from theoremsearch_tpu_torch.serve.app import SearchService
from theoremsearch_tpu_torch.serve.http_api import SearchServer
from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

torch.set_num_threads(1)

N_SLOGANS, N = 256, 4096
TEXTS = [f"every {w} of rank {i} has a {v} decomposition" for i, (w, v) in enumerate(
    zip(["group", "ring", "space", "module"] * 64, ["unique", "finite", "dual", "graded"] * 64))]


@pytest.fixture(scope="module")
def stack():
    cfg = EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    enc = BatchedEncoder(params, cfg, batch_size=64)
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((N, cfg.embedding_dim)).astype(np.float32)
    corpus[:N_SLOGANS] = enc.encode(TEXTS)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    meta = CorpusMetadata.from_rows(
        [{"slogan": TEXTS[i] if i < N_SLOGANS else "", "theorem_name": "Theorem",
          "link": f"https://arxiv.org/abs/2402.{i:05d}" if i < N - 8 else f"https://stacks.math/{i}",
          "theorem_body": f"$x_{i}$"}
         for i in range(N)])
    engine = SearchEngine(FlatIndex.build(corpus, config=IndexConfig(dtype="int8", int8_scale="global"),
                                            device="cpu"),
                          meta=meta, rescore_vectors=corpus, device="cpu")
    sched = BatchScheduler(engine, max_batch=64, max_wait_ms=20, encode_fn=enc.encode_device)
    service = SearchService(engine, enc.encode, scheduler=sched)
    server = SearchServer(service, "127.0.0.1", 0).start()
    yield engine, enc, service, sched, server
    server.stop()
    sched.shutdown()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_search_matches_direct_path(stack):
    engine, enc, _, sched, server = stack
    queries = [TEXTS[(7 * i) % N_SLOGANS] for i in range(24)]
    with ThreadPoolExecutor(12) as ex:
        answers = list(ex.map(lambda t: _post(server.port, "/search", {"query": t, "top_k": 10}),
                              queries))
    direct = SearchService(engine, enc.encode)
    for text, (code, body) in zip(queries, answers):
        assert code == 200
        rows = body["results"]
        assert len(rows) == 10
        assert all("display_markdown" in r and "theorem_slogan" in r for r in rows)
        assert [r["doc_id"] for r in rows] == [r["doc_id"] for r in direct.search_and_display(text)]
    st = sched.stats()
    assert st["queries"] >= 24 and st["batches"] < 24 and st["errors"] == 0
    assert "stages_ms" in st


def test_scheduler_vectors_and_mixed_groups(stack):
    engine, enc, _, sched, _ = stack
    vecs = enc.encode(TEXTS[:6])
    futs = [sched.submit(v, k=5) for v in vecs] + [sched.submit_text(t, k=5) for t in TEXTS[6:9]]
    got = [f.result(30) for f in futs]
    _, want = engine.search_vectors(enc.encode(TEXTS[:9]), k=5)
    for (s, i), w in zip(got, want):
        assert s.shape == (5,)
        np.testing.assert_array_equal(i, w)


def test_health_and_unported_routes(stack, monkeypatch):
    """/health, filters over HTTP, and the live routes: POST /documents
    adds a slogan that /search then finds first, /documents/delete takes
    it out again, all 200; an engine feature that still raises
    NotImplementedError (the mesh) answers 501."""
    engine, _, service, _, server = stack
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "corpus": N}
    # filters reach the engine: the last 8 rows are Stacks Project docs
    code, body = _post(server.port, "/search", {"query": TEXTS[3], "filters": {"sources": ["Stacks Project"]}})
    assert code == 200
    assert sorted(r["doc_id"] for r in body["results"]) == list(range(N - 8, N))
    text = "every lattice of rank 9999 has a graded decomposition"
    code, body = _post(server.port, "/documents", {"documents": [
        {"slogan": text, "theorem_name": "Theorem", "link": "https://arxiv.org/abs/new"}]})
    assert code == 200 and body == {"doc_ids": [N]}
    code, body = _post(server.port, "/search", {"query": text, "top_k": 3})
    assert code == 200 and body["results"][0]["doc_id"] == N
    assert body["results"][0]["theorem_slogan"] == text
    code, body = _post(server.port, "/documents/delete", {"doc_ids": [N]})
    assert code == 200 and body == {"deleted": 1}
    code, body = _post(server.port, "/search", {"query": text, "top_k": 3})
    assert code == 200 and N not in [r["doc_id"] for r in body["results"]]
    assert engine.num_live == N

    def unported(docs):
        raise NotImplementedError("multi-device search is not ported yet")

    monkeypatch.setattr(service, "index_documents", unported)
    code, body = _post(server.port, "/documents", {"documents": [{"slogan": "new"}]})
    assert code == 501 and "not ported" in body["error"]
