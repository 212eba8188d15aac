"""The port's spans and the encoder's counters, on the CPU: `span()` is a
shared no-op context unless a profiler records on the thread; under
`utils.profiling.trace` the pipeline, the encoder and the engine leave
their `ts.*` stages in the Chrome trace, nested as the code nests them;
`BatchedEncoder.stats()` counts slots and real tokens as a hand count
does. This file imports no jax."""

import json
import threading

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import init_params
from theoremsearch_tpu_torch.index.builder import IndexBuilder
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.ingest.catalog import Catalog
from theoremsearch_tpu_torch.pipeline import embed_missing_slogans
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.utils import profiling
from theoremsearch_tpu_torch.utils.profiling import span, trace

torch.set_num_threads(1)

CFG = EncoderConfig(vocab_size=1000, hidden_size=64, intermediate_size=128, num_layers=1,
                    num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=32, embedding_dim=64)
WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu".split()
ENCODER_STAGES = {"ts.encoder.tokenize", "ts.encoder.pad", "ts.encoder.forward",
                  "ts.encoder.to_host"}


def _encoder(batch_size=16, buckets=(16, 32)) -> BatchedEncoder:
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    return BatchedEncoder(params, CFG, batch_size=batch_size, buckets=buckets, device="cpu")


def _text(n_words: int) -> str:
    return " ".join(WORDS[i % len(WORDS)] for i in range(n_words))


def _spans(prof) -> list[dict]:
    """The trace's ts.* annotations in start order."""
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("ts.")), key=lambda e: e["ts"])


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_span_is_the_shared_null_context_without_a_profiler():
    # the guard is the C++ flag that record_function obeys, which is per thread
    assert profiling._profiler_on is torch._C._autograd._profiler_enabled
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("ts.test.a"), span("ts.test.b")
    assert a is b is profiling._NO_SPAN
    with a, b:                      # reentrant: nested use of the one object
        pass
    seen = {}

    def other_thread():
        seen["span"] = span("ts.test.thread")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("ts.test.on"), torch.profiler.record_function)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    # the profiler records the thread that started it: no span elsewhere
    assert seen["span"] is profiling._NO_SPAN
    assert span("ts.test.off") is profiling._NO_SPAN


def _fill(cat: Catalog, texts: list[str]) -> None:
    conn = cat.conn
    conn.executemany("INSERT INTO paper (paper_id, title, authors, link, primary_category,"
                     " citations) VALUES (?, ?, '[]', ?, 'math.AG', 0)",
                     [(f"p{j}", f"Paper {j}", f"https://arxiv.org/abs/2401.{j:05d}")
                      for j in range(len(texts))])
    conn.executemany("INSERT INTO theorem (theorem_id, paper_id, name, body, label,"
                     " parsing_method) VALUES (?, ?, ?, '', '', 'scanner')",
                     [(i + 1, f"p{i}", f"Theorem {i}") for i in range(len(texts))])
    conn.executemany("INSERT INTO theorem_slogan (slogan_id, theorem_id, model, prompt_id,"
                     " slogan) VALUES (?, ?, 'offline-stub', 'body-only-v1', ?)",
                     [(i + 1, i + 1, t) for i, t in enumerate(texts)])
    conn.commit()


def test_pipeline_and_encoder_spans_nest_in_the_trace(tmp_path):
    be = _encoder(batch_size=8)
    cat = Catalog(str(tmp_path / "catalog.db"))
    _fill(cat, [_text(3 + (i * 7) % 40) for i in range(40)])
    builder = IndexBuilder(tmp_path / "spool", IndexConfig(dim=CFG.embedding_dim))
    with trace(str(tmp_path / "trace"), device="cpu") as prof:
        done = embed_missing_slogans(cat, be.for_role("document"), builder, page_size=16)
    cat.close()
    assert done == 40
    spans = _spans(prof)
    names = [e["name"] for e in spans]
    pipeline = {"ts.pipeline.page", "ts.pipeline.encode", "ts.pipeline.spool",
                "ts.pipeline.manifest"}
    assert set(names) == pipeline | ENCODER_STAGES
    # three pages of 16, 16 and 8 rows, and the fetch that finds none
    assert names.count("ts.pipeline.page") == 4
    for stage in ("ts.pipeline.encode", "ts.pipeline.spool", "ts.pipeline.manifest",
                  "ts.encoder.tokenize", "ts.encoder.to_host"):
        assert names.count(stage) == 3, stage
    # a page of 16 runs two sub-batches of 8, the page of 8 one
    assert names.count("ts.encoder.pad") == names.count("ts.encoder.forward") == 5
    encodes = [e for e in spans if e["name"] == "ts.pipeline.encode"]
    for e in spans:
        if e["name"] in ENCODER_STAGES:
            assert any(_inside(e, outer) for outer in encodes), e
        else:                       # the pipeline's stages are siblings
            others = [o for o in spans if o["name"] in pipeline and o is not e]
            assert not any(_inside(e, o) for o in others), e


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((4096, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    return emb, q


@pytest.mark.parametrize("route", ["speed", "exact"])
def test_search_records_the_engine_stages_in_order(tmp_path, corpus, route):
    emb, q = corpus
    if route == "speed":
        eng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8",
                                                                   int8_scale="global"),
                                           device="cpu"), rescore_vectors=emb, device="cpu")
        want = ["ts.engine.upload", "ts.engine.scan", "ts.engine.rescore",
                "ts.engine.to_host", "ts.engine.finalize"]
    else:
        eng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8"), device="cpu"),
                           device="cpu")
        want = ["ts.engine.upload", "ts.engine.scan", "ts.engine.to_host",
                "ts.engine.finalize"]
    assert eng._speed_ok == (route == "speed")
    s0, i0 = eng.search_vectors(q, k=5)
    with trace(str(tmp_path), device="cpu") as prof:
        s1, i1 = eng.search_vectors(q, k=5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    assert eng.route_counts[route] == 2
    # no wait on the CPU: the copies back are the arrays themselves
    assert [e["name"] for e in _spans(prof)] == want


def test_encoder_stats_match_a_hand_count():
    be = _encoder(batch_size=16, buckets=(16, 32))
    assert all(len(be.tokenizer.tokenize(_text(n))) == n for n in (1, 3, 40))
    empty = be.stats()
    assert empty == {"calls": 0, "texts": 0, "sub_batches": 0, "token_slots": 0,
                     "real_tokens": 0, "by_shape": {}}
    # one sub-batch: 3 rows padded to 8, widest 10 + 2 tokens in the 16 bucket
    be.encode([_text(3), _text(10), _text(5)])
    s = be.stats()
    assert (s["sub_batches"], s["token_slots"], s["real_tokens"]) == (1, 8 * 16, 5 + 12 + 7)
    # 17 one-word texts and 3 of 40 words (cut to the widest bucket, 32):
    # sorted by length, 16 short rows at (16, 16), then 1 short + 3 long
    # rows padded to 8 at (8, 32)
    be.for_role("document")([_text(40)] * 3 + [_text(1)] * 17)
    s = be.stats()
    assert s == {"calls": 2, "texts": 23, "sub_batches": 3,
                 "token_slots": 8 * 16 + 16 * 16 + 8 * 32,
                 "real_tokens": 24 + 16 * 3 + (3 + 3 * 32),
                 "by_shape": {(8, 16): 1, (16, 16): 1, (8, 32): 1}}
    # encode_device counts the caller's texts; its power-of-two padding
    # rows are empty strings, two specials each
    be.encode_device([_text(2)])
    s2 = be.stats()
    assert (s2["calls"], s2["texts"], s2["sub_batches"]) == (3, 24, 4)
    assert s2["real_tokens"] - s["real_tokens"] == 4 + 7 * 2
    assert s2["by_shape"][(8, 16)] == 2
    # a copy: the caller's dict does not move with the counters
    s2["by_shape"].clear()
    assert be.stats()["by_shape"][(8, 16)] == 2
