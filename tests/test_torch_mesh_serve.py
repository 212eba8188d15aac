"""Port parity: serving over the row-sharded engine (the scheduler, the
service and HTTP), data-parallel encoding (`BatchedEncoder(mesh=)`),
`build_engine_from_catalog(mesh=)` and `entry.dryrun_multichip`, against
the JAX package on its 8-device CPU mesh and the port's single-device
path: twins of tests/test_scheduler.py's and tests/test_http_api.py's
mesh cases.

The port's meshes repeat "cpu" (`torch_helpers.cpu_mesh`). Ids must be
equal wherever the scores are unique (`test_torch_live_updates._agree`);
served answers equal the single-device service's, as the reference tests
require of theirs."""

import hashlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core.config import EncoderConfig, GemmaEncoderConfig, IndexConfig
from theoremsearch_tpu_torch.encoder import gemma as gemma_mod
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import init_params
from theoremsearch_tpu_torch.entry import dryrun_multichip
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
from theoremsearch_tpu_torch.serve.app import SearchService
from theoremsearch_tpu_torch.serve.http_api import SearchServer
from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

from test_torch_live_updates import _agree
from test_torch_pipeline import _search, _ten_papers, _queries
from test_torch_pipeline import twin as pipeline_twin
from torch_helpers import cpu_mesh, serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()

GLOBAL = dict(pad_multiple=256, dtype="int8", int8_scale="global")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rows(n, year=lambda i: 2020):
    return [{"paper_id": f"p{i}", "paper_title": "T", "authors": [], "link": "https://arxiv.org/abs/x",
             "year": year(i), "primary_category": "math.AG" if i % 2 else "math.NT",
             "journal_ref": None, "citations": i, "theorem_name": "Theorem 1.", "theorem_body": "b",
             "slogan": "s"} for i in range(n)]


def _engines(emb, rows, shards=4):
    """(JAX mesh engine, port mesh engine, port single-device engine) on
    the speed path, rescore factor 8."""
    jeng = JSearchEngine(JFlatIndex.build(emb, config=JIndexConfig(**GLOBAL), normalize=False),
                         meta=JCorpusMetadata.from_rows(rows),
                         mesh=j_make_mesh(JMeshConfig(data=1, shard=shards)), use_pallas=True,
                         pallas_interpret=True, row_block=128, rescore_vectors=emb, rescore_factor=8)
    tidx = FlatIndex.build(emb, config=IndexConfig(**GLOBAL), normalize=False, device="cpu")
    teng = SearchEngine(tidx, meta=CorpusMetadata.from_rows(rows), mesh=cpu_mesh(shards), row_block=128,
                        rescore_vectors=emb, rescore_factor=8)
    t1 = SearchEngine(tidx, meta=CorpusMetadata.from_rows(rows), device="cpu", row_block=128,
                      rescore_vectors=emb, rescore_factor=8)
    return jeng, teng, t1


def test_scheduler_over_multichip_engine():
    """The scheduler's async dispatch and resolver pool over the sharded
    speed path, filtered and unfiltered mixed: self-matches, the filter
    held, and each answer the JAX mesh engine's for the same request."""
    emb = _unit(np.random.default_rng(7), 2048, 64)
    jeng, teng, _ = _engines(emb, _rows(2048))
    sched = BatchScheduler(teng, max_batch=16, max_wait_ms=20, filter_coalesce_ms=30)
    try:
        futs = [sched.submit(emb[i], k=5, filters=SearchFilters(tags=["math.AG"]) if i % 3 == 0 else None)
                for i in range(1, 13)]
        for i, fu in enumerate(futs, start=1):
            s, ids = fu.result(30)
            filtered = i % 3 == 0
            if not filtered or i % 2 == 1:
                assert ids[0] == i
            if filtered:
                assert all(teng.meta.primary_category[d] == "math.AG" for d in ids if d >= 0)
            js, ji = jeng.search_vectors(emb[i][None], k=5,
                                         filters=JSearchFilters(tags=["math.AG"]) if filtered else None)
            _agree(js, ji, s[None], ids[None], f"request {i}")
    finally:
        sched.shutdown()


def test_grouped_scheduler_over_sharded_engine_matches_single():
    """Grouped filtered coalescing over the mesh engine: each answer's ids
    equal the single-device engine's and the JAX mesh engine's."""
    emb = _unit(np.random.default_rng(9), 1024, 64)
    jeng, teng, t1 = _engines(emb, _rows(1024, year=lambda i: 2000 + i % 20))
    sched = BatchScheduler(teng, max_batch=32, max_wait_ms=10, filter_coalesce_ms=60,
                           filter_coalesce_min=12)
    sigs = [None, dict(tags=["math.AG"]), dict(year_range=(2005, 2012)), dict(citation_range=(0, 100))]
    try:
        futs = [(i, sched.submit(emb[i], k=6, filters=None if sigs[i % 4] is None
                                 else SearchFilters(**sigs[i % 4]))) for i in range(2, 18)]
        for i, fu in futs:
            _, ids = fu.result(30)
            f = sigs[i % 4]
            _, i_ref = t1.search_vectors(emb[i][None], k=6, filters=None if f is None else SearchFilters(**f))
            assert set(ids.tolist()) == set(i_ref[0].tolist()), f"req {i}"
            _, ji = jeng.search_vectors(emb[i][None], k=6, filters=None if f is None else JSearchFilters(**f))
            assert set(ids.tolist()) == set(np.asarray(ji)[0].tolist()), f"req {i}"
    finally:
        sched.shutdown()


def _hash_encode(texts, d=64):
    out = np.zeros((len(texts), d), np.float32)
    for i, t in enumerate(texts):
        for tok in t.lower().split():
            out[i, int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little") % d] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)


def test_full_serving_stack_over_mesh():
    """BatchScheduler + SearchService + HTTP over a meshed engine with
    concurrent filtered and unfiltered clients: every answer equals the
    single-device service's where the scores are unique, and the stage
    traces populate."""
    n = 1024
    bodies = [f"statement about subject {i % 40} flavor {i % 7}" for i in range(n)]
    rows = [{"paper_id": f"p{i}", "paper_title": f"Title {i}", "authors": [f"A{i % 5}"],
             "link": "https://arxiv.org/abs/x", "year": 2000 + i % 20,
             "primary_category": "math.NT" if i % 2 else "math.AG", "journal_ref": None,
             "citations": i % 60, "theorem_name": "Theorem 1.", "theorem_body": bodies[i],
             "slogan": f"slogan {i}"} for i in range(n)]
    idx = FlatIndex.build(_hash_encode(bodies), config=IndexConfig(**GLOBAL), normalize=True, device="cpu")
    rescore = idx.vectors.float() * idx.global_scale

    def build(mesh, sched_kw=None):
        eng = SearchEngine(idx, meta=CorpusMetadata.from_rows(rows), mesh=mesh,
                           device=None if mesh is not None else "cpu", row_block=128,
                           rescore_vectors=rescore, rescore_factor=8)
        sched = BatchScheduler(eng, encode_fn=_hash_encode, **sched_kw) if sched_kw else None
        return SearchService(eng, _hash_encode, scheduler=sched), sched

    svc_m, sched = build(cpu_mesh(4), dict(max_batch=32, max_wait_ms=10, filter_coalesce_ms=40,
                                           filter_coalesce_min=8))
    svc_1, _ = build(None)
    payloads = []
    for i in range(18):
        p = {"query": f"statement about subject {i % 40}", "top_k": 5}
        if i % 3 == 0:
            p["filters"] = {"year_range": [2004, 2012]}
        elif i % 3 == 1:
            p["filters"] = {"tags": ["math.AG"]}
        payloads.append(p)
    srv = SearchServer(svc_m, "127.0.0.1", 0).start()
    results, errors = {}, []

    def client(i):
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/search",
                                         data=json.dumps(payloads[i]).encode(),
                                         headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 - collected for the assert below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(18)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]
        for i, got in results.items():
            f = payloads[i].get("filters", {})
            kw = {"year_range": tuple(f["year_range"])} if "year_range" in f else dict(f)
            ref = svc_1.search_and_display(payloads[i]["query"], SearchFilters(top_k=5, **kw))
            # equal scores; equal ids wherever the score is unique and above
            # the last slot's (the bag-of-words corpus ties often, and the
            # k-th slot's ties reach past the list)
            sw = np.array([r["similarity"] for r in ref], np.float32)
            sg = np.array([r["similarity"] for r in got["results"]], np.float32)
            np.testing.assert_allclose(sg, sw, atol=1e-5, err_msg=f"client {i}")
            iw = np.array([r["doc_id"] for r in ref])
            ig = np.array([r["doc_id"] for r in got["results"]])
            near = (np.abs(sw[:, None] - sw[None, :]) <= 1e-5).sum(1) > 1
            near |= sw <= sw[-1] + 1e-5
            np.testing.assert_array_equal(ig[~near], iw[~near], err_msg=f"client {i}")
        st = sched.stats()
        assert st["batches"] >= 1 and st["stages_ms"]["total_ms"]["max"] > 0
    finally:
        srv.stop()
        sched.shutdown()


# ------------------------------------------------- data-parallel encode


def _gemma_cfg():
    # head_dim 256 (the gemma form of the attention core), 2 layers
    return GemmaEncoderConfig.tiny().replace(hidden_size=256, intermediate_size=384, num_heads=2,
                                             num_kv_heads=1, head_dim=256, num_layers=2)


@pytest.mark.parametrize("tower, quant, data", [
    ("qwen", "none", 2), ("qwen", "int8", 2), ("qwen", "none", 4), ("gemma", "int8", 2),
])
def test_data_parallel_encode_matches_one_device(tower, quant, data):
    """BatchedEncoder on a data mesh: each sub-batch split over the data
    axis and gathered in order gives the single-device encoder's pooled
    rows (cosine >= 0.9999; the CPU products agree to the last bits),
    for encode and encode_device, in bf16 and int8."""
    if tower == "qwen":
        cfg = EncoderConfig.tiny()
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    else:
        cfg = _gemma_cfg()
        params = gemma_mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    texts = [f"theorem {i} on {'graded ' * (i % 9)}modules" for i in range(37)]
    one = BatchedEncoder(params, cfg, device="cpu", quant=quant, batch_size=16)
    dp = BatchedEncoder(params, cfg, mesh=cpu_mesh(1, data=data), quant=quant, batch_size=16)
    a, b = one.encode(texts), dp.encode(texts)
    assert a.shape == b.shape == (37, cfg.embedding_dim)
    assert (a * b).sum(axis=1).min() >= 0.9999
    da, db = one.encode_device(texts[:5]), dp.encode_device(texts[:5])
    assert db.shape == (8, cfg.embedding_dim) and db.device == torch.device("cpu")
    assert (da[:5] * db[:5]).sum(dim=1).min() >= 0.9999


def test_tensor_parallel_encode_raises():
    """int8 on a mesh with shard > 1 raises ("dp-only", the reference's
    rule: the tp rules have no int8 form); bf16 encodes there, with full
    params data-parallel and with sharded ones tensor-parallel, equal to
    the one-device encoder."""
    from theoremsearch_tpu_torch.encoder.model import shard_params

    cfg = EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = cpu_mesh(2, data=2)
    with pytest.raises(ValueError, match="dp-only"):
        BatchedEncoder(params, cfg, mesh=mesh, quant="int8")
    texts = [f"theorem {i} on {'graded ' * (i % 5)}modules" for i in range(9)]
    one = BatchedEncoder(params, cfg, device="cpu", batch_size=8).encode(texts)
    for p in (params, shard_params(params, mesh)):
        out = BatchedEncoder(p, cfg, mesh=mesh, batch_size=8).encode(texts)
        assert (out * one).sum(axis=1).min() >= 0.9999


# ------------------------------------------ the catalog path, the dry run


def test_build_engine_from_catalog_on_a_mesh(tmp_path):
    """build_engine_from_catalog(mesh=): the rebuilt engine row-sharded
    over 4 shards; its searches agree with the JAX package's meshed
    engine (twin through test_torch_pipeline.twin)."""
    def scenario(pkg, tmp):
        mesh = j_make_mesh(JMeshConfig(data=1, shard=4)) if pkg.jax else cpu_mesh(4)
        engine = pkg.build(tmp / "spool", mesh=mesh)
        assert engine.n_valid == 10 and engine.rows_per_shard * 4 == engine.padded_rows
        rows = pkg.SearchService(engine, _hash_encode_128).search_and_display(
            "graph colorings", pkg.SearchFilters(top_k=3))
        assert "graph colorings" in rows[0]["theorem_body"]
        return {"exact": _search(engine, _queries(16), 10)}

    pipeline_twin(tmp_path, _ten_papers, scenario)


def _hash_encode_128(texts):
    from test_torch_pipeline import _hash_encode as enc

    return enc(texts)


def test_dryrun_multichip_on_the_cpu():
    """The reference's multi-device dry run, on a (2, 4) mesh of repeated
    "cpu" devices; the line names each item (the train step's loss first;
    its parity with the reference: tests/test_torch_tp_train.py)."""
    line = dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip ok: mesh=(2x4)")
    for item in ("loss=", "speed_path", "filtered_speed_path", "residual_capacity_path", "live_updates",
                 "scheduler", "sharded_ivf_top1"):
        assert item in line
