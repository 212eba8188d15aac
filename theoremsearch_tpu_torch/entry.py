"""Entry point of the port (counterpart of `__graft_entry__.entry`): the
pooled encoder forward with example inputs.

    fn, args = entry()              # on the card
    out = fn(*args)                 # (8, 1024) f32, L2-normalized

On the card: the Qwen3-Embedding-0.6B-class `EncoderConfig(max_seq_len=128)`
with random weights, its attention through kernel B2. With device="cpu":
the tiny config on the plain path.

`dryrun_multichip(n_devices)` is the reference's multi-device dry run
(`__graft_entry__.dryrun_multichip`) on one process: the full training
step (dp batches + tp params, a finite loss), then the sharded speed
path, the filtered and residual forms, live updates with compact and
reclaim, the scheduler and the list-sharded IVF over a mesh, each held
to the single-device engine. The run across processes (the reference's
`tests/test_multihost.py`) is `core/distributed.py:initialize` then the
same calls on a mesh from `make_mesh` (`tests/torch_multihost_worker.py`
drives it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core.config import EncoderConfig
from .encoder.model import encode_pooled, init_params
from .encoder.tokenizer import SimpleTokenizer
from .utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): fn(params, input_ids, attention_mask) -> (8, D)."""
    device = resolve_device(device)
    cfg = EncoderConfig(max_seq_len=128) if device.type == "cuda" else EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    enc = tok(["classification of finite simple groups", "bound the chromatic number"],
              pad_to=min(64, cfg.max_seq_len))
    # a batch of 8: the two texts four times
    ids = torch.from_numpy(np.concatenate([enc.input_ids] * 4)).to(device)
    mask = torch.from_numpy(np.concatenate([enc.attention_mask] * 4)).to(device)
    return functools.partial(encode_pooled, cfg=cfg, fused="on"), (params, ids, mask)


def _mesh_devices(n_devices: int, device) -> list:
    """n_devices mesh entries: the distinct cards when there are that
    many, else `device` repeated (one card, or the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def _train_item(mesh, state) -> float:
    """The dry run's first item, the full training step (dp batches + tp
    params): one step of `EncoderConfig.tiny()` from `state` (sharded on
    `mesh`) on 2 pairs a data row of 16 tokens; returns the loss, raising
    if it is not finite."""
    from .core.config import TrainConfig
    from .train.contrastive import make_train_step

    enc_cfg = EncoderConfig.tiny()
    tcfg = TrainConfig(batch_size=2 * mesh.shape["data"], seq_len=16)
    tok = SimpleTokenizer(vocab_size=enc_cfg.vocab_size)
    q = tok([f"query {i}" for i in range(tcfg.batch_size)], pad_to=tcfg.seq_len)
    p = tok([f"positive {i}" for i in range(tcfg.batch_size)], pad_to=tcfg.seq_len)
    _, loss = make_train_step(enc_cfg, tcfg, mesh=mesh)(
        state, q.input_ids, q.attention_mask, p.input_ids, p.attention_mask)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError("training loss not finite")
    return loss


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The reference's multi-device dry run over a (data, shard) mesh of
    `n_devices` entries (`_mesh_devices`): one dp + tp train step of the
    tiny encoder, then the serving items, each held to the single-device
    engine; raises on a mismatch, prints and returns one summary line."""
    from .core.config import IndexConfig, MeshConfig, TrainConfig
    from .core.meshes import make_mesh
    from .index.flat import FlatIndex
    from .index.ivf import IVFIndex
    from .search.engine import SearchEngine
    from .search.filters import SearchFilters
    from .search.metadata import CorpusMetadata
    from .serve.scheduler import BatchScheduler
    from .train.contrastive import init_sharded_train_state

    devices = _mesh_devices(n_devices, device)
    dev = devices[0]
    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    shard = n_devices // data
    mesh = make_mesh(MeshConfig(data=data, shard=shard), devices=devices)

    # ---- the full training step: dp batches + tp params ----
    loss = _train_item(mesh, init_sharded_train_state(EncoderConfig.tiny(), TrainConfig(), mesh))

    def same(got, want, what):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"{what} != single-device ids")

    # ---- the sharded speed path: per-shard maxima scan + local rescore +
    # the merge on the first device ----
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((shard * 512, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = FlatIndex.build(emb, config=IndexConfig(pad_multiple=128, dtype="int8", int8_scale="global"),
                          normalize=False, device=dev)

    def engine(index, m, **kw):
        return SearchEngine(index, mesh=m, device=None if m is not None else dev, row_block=128,
                            rescore_factor=8, **kw)

    eng = engine(idx, mesh, rescore_vectors=emb)
    if not eng._speed_ok:
        raise AssertionError("the sharded speed path must be active")
    queries = rng.standard_normal((8, 128)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    scores, ids = eng.search_vectors(queries, k=10)
    if scores.shape != (8, 10) or not (ids >= 0).all():
        raise AssertionError("sharded speed path: bad result shape or padding")
    same(ids, engine(idx, None, rescore_vectors=emb).search_vectors(queries, k=10)[1],
         "sharded speed path")

    # ---- the filtered sharded speed path: the mask row-sharded ----
    meta_rows = [{"paper_id": f"p{i}", "paper_title": f"Paper {i}", "authors": [f"A{i % 5}"],
                  "link": f"https://arxiv.org/abs/{i}", "year": 2000 + (i % 25),
                  "primary_category": "math.AG", "journal_ref": None, "citations": i % 40,
                  "theorem_name": "Theorem 1.", "theorem_body": f"body {i}", "slogan": f"slogan {i}"}
                 for i in range(emb.shape[0])]
    meta = CorpusMetadata.from_rows(meta_rows)
    eng_f = engine(idx, mesh, meta=meta, rescore_vectors=emb)
    eng_f1 = engine(idx, None, meta=meta, rescore_vectors=emb)
    filters = SearchFilters(sources=["arXiv"], year_range=(2005, 2015))
    _, i_f = eng_f.search_vectors(queries, k=10, filters=filters)
    same(i_f, eng_f1.search_vectors(queries, k=10, filters=filters)[1], "sharded filtered speed path")
    if not all(2005 <= meta.year[int(d)] <= 2015 for d in i_f.ravel() if d >= 0):
        raise AssertionError("sharded filtered speed path returned a row outside the filter")

    # ---- the residual capacity mode, both levels sharded ----
    idx_r = FlatIndex.build(emb, config=IndexConfig(pad_multiple=128, dtype="int8",
                                                    int8_scale="global", residual=True),
                            normalize=False, device=dev)
    eng_r = engine(idx_r, mesh)
    if not (eng_r._speed_ok and eng_r.rescore_residual is not None):
        raise AssertionError("the sharded residual path must be active")
    same(eng_r.search_vectors(queries, k=10)[1], engine(idx_r, None).search_vectors(queries, k=10)[1],
         "sharded residual path")

    # ---- live updates under the mesh: the delta on the first device,
    # tombstones through the over-fetch, compact re-shards ----
    eng_live, eng_live1 = engine(idx, mesh, rescore_vectors=emb), engine(idx, None, rescore_vectors=emb)
    new_vecs = rng.standard_normal((6, 128)).astype(np.float32)
    new_vecs /= np.linalg.norm(new_vecs, axis=1, keepdims=True)
    for e in (eng_live, eng_live1):
        ids_new = e.add_documents(new_vecs, normalize=False)
        if int(ids_new[0]) != emb.shape[0]:
            raise AssertionError("live add: unexpected first id")
        e.update_document(3, new_vecs[0])
        if e.delete_documents([7, int(ids_new[-1])]) != 2:
            raise AssertionError("live delete: two docs were live")
    same(eng_live.search_vectors(queries, k=10)[1], eng_live1.search_vectors(queries, k=10)[1],
         "sharded live mutations")
    if eng_live.compact(reclaim=True) != eng_live1.compact(reclaim=True):
        raise AssertionError("sharded compact folded another count")
    same(eng_live.last_id_map, eng_live1.last_id_map, "sharded reclaim id map")
    same(eng_live.search_vectors(queries, k=10)[1], eng_live1.search_vectors(queries, k=10)[1],
         "post-compact sharded")

    # ---- the scheduler over the mesh, filtered and unfiltered mixed ----
    sched = BatchScheduler(eng_f, max_batch=16, max_wait_ms=15, filter_coalesce_ms=30,
                           filter_coalesce_min=4)
    try:
        futs = [sched.submit(queries[i % 8], k=5, filters=filters if i % 2 else None)
                for i in range(8)]
        for i, fu in enumerate(futs):
            _, ids_s = fu.result(120)
            _, ids_ref = eng_f1.search_vectors(queries[i % 8][None], k=5,
                                               filters=filters if i % 2 else None)
            if {int(d) for d in ids_s} != {int(d) for d in ids_ref[0]}:
                raise AssertionError("scheduler over the mesh != single-device ids")
        sched_stats = sched.stats()
    finally:
        sched.shutdown()

    # ---- the list-sharded IVF, alone and behind the engine ----
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, 16, 4096)
    pts = centers[assign] + (0.7 / np.sqrt(128)) * rng.standard_normal((4096, 128)).astype(np.float32)
    ivf = IVFIndex.build(pts, config=IndexConfig(ivf_nlist=16, dtype="int8", ivf_assign2_margin=0.02),
                         slab_rows=384, device=dev)
    ivf_mesh = make_mesh(MeshConfig(data=1, shard=data * shard), devices=devices)
    s_ivf, i_ivf = ivf.sharded_searcher(ivf_mesh, k=5, nprobe=4)(queries)
    i_ivf = i_ivf.cpu().numpy()
    if s_ivf.shape != (8, 5) or not (i_ivf[:, 0] >= 0).all():
        raise AssertionError("sharded IVF: bad result")
    flat_pts = FlatIndex.build(pts, config=IndexConfig(pad_multiple=1024, dtype="float32"),
                               normalize=False, device=dev)
    eng_ivf = SearchEngine(flat_pts, mesh=ivf_mesh, row_block=128, ivf_index=ivf, ivf_nprobe=4,
                           rescore_factor=8)
    _, i_ei = eng_ivf.search_vectors(queries, k=5)
    if i_ei.shape != (8, 5) or not (i_ei[:, 0] >= 0).all() or eng_ivf.route_counts.get("ivf", 0) < 1:
        raise AssertionError("engine-integrated meshed IVF: bad result or route")
    line = (f"dryrun_multichip ok: mesh=({data}x{shard}) on {sorted({str(d) for d in devices})}, "
            f"loss={loss:.4f}, "
            f"speed_path=sharded-maxima-scan+local-rescore (ids == single-dev), "
            f"filtered_speed_path=sharded-masked-scan (ids == single-dev), "
            f"residual_capacity_path=sharded-two-level-int8 (ids == single-dev), "
            f"live_updates=sharded add/update/delete/compact(reclaim) (ids == single-dev), "
            f"scheduler=micro-batched serving over the mesh "
            f"({sched_stats['batches']} batches, ids == single-dev), "
            f"sharded_ivf_top1={int(i_ivf[0, 0])} (+engine-integrated meshed IVF)")
    print(line)
    return line
