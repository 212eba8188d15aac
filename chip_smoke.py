#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero (there is no CPU path):

 1. env      card name and power limit, torch/CUDA versions, TF32 off.
 2. build    nvcc build of the kernels in theoremsearch_tpu_torch/csrc.
 3. b1       packed lane-maxima scan kernel vs its plain version,
             B=1024, D=1024, row_block=4096, N=262144, padded and
             unpadded, merge_tiles 1 and 4: bit-equal candidates, equal
             decoded (scores, ids).
 4. b2       fused attention kernel vs its plain version, H=16/8,
             Dh=128, S in {32, 64, 128} at B=64 and the encoder's
             (B, S) = (512, 64), ragged masks.
 5. encoder  full-width Qwen3-0.6B-class encoder (28 layers, random bf16
             weights from a seeded generator): kernel path vs plain path
             cosine, then 4,096 slogans through BatchedEncoder.
 6. index    1,048,576 x 1024 corpus (random unit rows; the first 4,096
             replaced by the encoder's embeddings of synthetic slogans),
             int8-global FlatIndex + bf16 rescore copy, SearchEngine
             speed path, min recall@10 over 5 draws of 1024 vs the fp32
             exact oracle.
 7. serve    SearchService + BatchScheduler + SearchServer on 127.0.0.1,
             128 POST /search from 64 client threads after one warm
             round of the same, overlap@10 vs the direct path.
 8. times    B1 vs plain on the engine's 1M index (bit-equal), kernel
             and plain times at the path's shapes, and torch.profiler
             tables of one encoder forward and one scan + rescore batch.

Launch counters are reset after phase 5's kernel-vs-plain comparison and
read after phase 7: the `launches` in the kernels line count the main
path's launches only (BatchedEncoder, SearchEngine, the HTTP stack).
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def slogans(n: int) -> list[str]:
    adj = ["compact", "connected", "finite", "normal", "regular", "smooth",
           "separable", "abelian", "noetherian", "projective", "reduced", "flat",
           "proper", "simple", "solvable", "bounded"]
    noun = ["group", "ring", "module", "scheme", "space", "manifold", "graph",
            "field", "sheaf", "operator", "measure", "lattice", "category",
            "variety", "algebra", "polytope"]
    verb = ["admits", "embeds into", "is dominated by", "acts on", "covers",
            "splits over", "is dense in", "maps onto"]
    prop = ["a unique fixed point", "a finite resolution", "a dual basis",
            "an invariant measure", "a universal cover", "a spectral gap",
            "a Jordan decomposition", "a canonical form"]
    out = []
    for i in range(n):
        a, b, c, d = i % 16, (i // 16) % 16, (i // 256) % 8, (i // 2048) % 8
        out.append(
            f"Every {adj[a]} {noun[b]} of rank {i} {verb[c]} {prop[d]} "
            f"whose {adj[(a + b) % 16]} {noun[(b + c + 3) % 16]} has index {7 * i + 3}."
        )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.model import encode_pooled, init_params
    from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
    from theoremsearch_tpu_torch.eval.oracle import exact_topk
    from theoremsearch_tpu_torch.index.flat import FlatIndex
    from theoremsearch_tpu_torch.index.quant import quantize_global_int8
    from theoremsearch_tpu_torch.kernels import _build
    from theoremsearch_tpu_torch.kernels.attention import (
        attention_launches, fused_qknorm_rope_attention, fused_qknorm_rope_attention_plain,
    )
    from theoremsearch_tpu_torch.kernels.mips import (
        auto_merge_tiles, device_rescore, mips_g_launches, mips_g_scan,
        mips_g_scan_plain, quantize_queries, select_candidates,
    )
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from theoremsearch_tpu_torch.serve.app import SearchService
    from theoremsearch_tpu_torch.serve.http_api import SearchServer
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler
    from theoremsearch_tpu_torch.utils.device import gpu_name_power, require_cuda
    from torch.profiler import ProfilerActivity, profile

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_power()
    t_start = time.perf_counter()

    # ---- 1. env ----
    emit("env", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in _build.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=_build.build_seconds, ptxas=regs[:8])

    # ---- 3. B1 vs plain ----
    g = torch.Generator(device=dev).manual_seed(0)
    B, D, RB, N = 1024, 1024, 4096, 262_144
    x = torch.randn((N, D), generator=g, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    codes, gscale = quantize_global_int8(x)
    del x
    q = torch.randn((B, D), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    q8, qs = quantize_queries(q)
    b1_err = 0
    for n_valid in (N, N - 1000):
        for m in (1, 4):
            ck = mips_g_scan(q8, codes, n_valid, RB, m)
            cp = mips_g_scan_plain(q8, codes, n_valid, RB, m)
            torch.cuda.synchronize()
            err = int((ck.long() - cp.long()).abs().max())
            b1_err = max(b1_err, err)
            sk, ik = select_candidates(ck, qs, gscale, 40, RB, m)
            sp, ip = select_candidates(cp, qs, gscale, 40, RB, m)
            ok = torch.equal(ck, cp) and torch.equal(sk, sp) and torch.equal(ik, ip)
            emit("b1", n_valid=n_valid, merge_tiles=m, shape=list(ck.shape),
                 bit_equal=torch.equal(ck, cp), decoded_equal=ok, max_abs_err=err)
            if not ok:
                raise AssertionError(f"B1 kernel disagrees with its plain version (n_valid={n_valid}, M={m})")
    del codes, ck, cp

    # ---- 4. B2 vs plain ----
    H, HK, DH = 16, 8, 128
    b2_err = 0.0
    # B=64 over the kernel's S range, and the encoder's (512, 64) batches
    for BB, S in ((64, 32), (64, 64), (64, 128), (512, 64)):
        qa = (torch.randn((BB, S, H * DH), generator=g, device=dev) * 2).to(torch.bfloat16)
        ka = (torch.randn((BB, S, HK * DH), generator=g, device=dev) * 2).to(torch.bfloat16)
        va = torch.randn((BB, S, HK * DH), generator=g, device=dev).to(torch.bfloat16)
        qw = 1.0 + 0.1 * torch.randn((DH,), generator=g, device=dev)
        kw = 1.0 + 0.1 * torch.randn((DH,), generator=g, device=dev)
        lens = torch.randint(1, S + 1, (BB,), generator=g, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        pos = torch.clamp(mask.cumsum(1) - 1, min=0).float()
        inv = 1.0 / (1e6 ** (torch.arange(0, DH, 2, device=dev).float() / DH))
        ang = pos[..., None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        kwargs = dict(num_heads=H, num_kv_heads=HK, head_dim=DH, eps=1e-6, causal=True)
        ok_ = fused_qknorm_rope_attention(qa, ka, va, qw, kw, cos, sin, mask, **kwargs).float()
        op = fused_qknorm_rope_attention_plain(
            qa, ka, va, qw, kw, cos, sin, mask, scale=1.0 / np.sqrt(DH), **kwargs).float()
        torch.cuda.synchronize()
        err = float((ok_ - op).abs().max())
        ref = float(op.abs().max())
        a, b = ok_.double().flatten(), op.double().flatten()
        cosv = float((a @ b) / (a.norm() * b.norm()))
        b2_err = max(b2_err, err)
        emit("b2", S=S, B=BB, cosine=cosv, max_abs_err=err, max_abs_plain=ref)
        if not (cosv > 0.9999 and err <= 2e-2 * ref):
            raise AssertionError(f"B2 kernel disagrees with its plain version at S={S}")

    # ---- 5. encoder at full width ----
    cfg = EncoderConfig()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    n_params = params["embed"].numel() + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    encoder = BatchedEncoder(params, cfg, batch_size=512, device=dev)
    texts = slogans(4096)
    ids_mask, _ = encoder._prep_batch(texts[:512], [encoder.tokenizer.tokenize(t) for t in texts[:512]],
                                      list(range(512)))
    t = torch.from_numpy(ids_mask).to(dev)
    with torch.inference_mode():
        pk = encode_pooled(params, t[0], t[1], cfg, fused="on")
        pp = encode_pooled(params, t[0], t[1], cfg, fused="plain")
        po = encode_pooled(params, t[0], t[1], cfg, fused="off")
        # the stack's own noise floor: the same plain path at another
        # batch size (other GEMM shapes, other f32 summation orders)
        ph = encode_pooled(params, t[0][:256], t[1][:256], cfg, fused="plain")
    # the main path runs from here to the end of phase 7; the comparison
    # launches above are not counted
    mips_g_launches.reset()
    attention_launches.reset()
    t0 = time.perf_counter()
    slogan_emb = encoder.encode(texts)
    enc_s = time.perf_counter() - t0
    enc_cos = (pk.double() * pp.double()).sum(1)
    off_cos = (pk.double() * po.double()).sum(1)
    floor_cos = (ph.double() * pp[:256].double()).sum(1)
    emit("encoder", params=n_params, layers=cfg.num_layers, hidden=cfg.hidden_size,
         encode_4096_s=round(enc_s, 3), width=int(t.shape[2]),
         cos_kernel_vs_plain_min=float(enc_cos.min()),
         cos_kernel_vs_reference_composition_min=float(off_cos.min()),
         cos_plain_b256_vs_plain_b512_min=float(floor_cos.min()),
         slogan_emb_mean_pairwise_cos=float(np.mean(slogan_emb[:256] @ slogan_emb[:256].T)),
         finite=bool(np.isfinite(slogan_emb).all()), attention_launches=attention_launches.n)
    if not (float(enc_cos.min()) > 0.9999 and attention_launches.n > 0
            and np.isfinite(slogan_emb).all() and slogan_emb.shape == (4096, cfg.embedding_dim)):
        raise AssertionError("encoder phase failed")

    # ---- 6. index and recall gate ----
    NC = 1_048_576
    t0 = time.perf_counter()
    corpus = np.empty((NC, D), np.float32)
    gc_ = torch.Generator(device=dev).manual_seed(7)
    for i in range(0, NC, 131_072):
        xc = torch.randn((131_072, D), generator=gc_, device=dev)
        corpus[i : i + 131_072] = (xc / xc.norm(dim=1, keepdim=True)).cpu().numpy()
    corpus[:4096] = slogan_emb
    index = FlatIndex.build(corpus, config=IndexConfig(dtype="int8", int8_scale="global"), device=dev)
    build_s = time.perf_counter() - t0
    n_meta = NC
    blank = [""] * n_meta
    meta = CorpusMetadata(
        paper_id=[f"p{i}" if i < 4096 else "" for i in range(n_meta)],
        paper_title=[f"Paper {i}" if i < 4096 else "" for i in range(n_meta)],
        authors=[[] for _ in range(n_meta)],
        link=[f"https://arxiv.org/abs/2401.{i:05d}" if i < 4096 else "" for i in range(n_meta)],
        year=np.zeros(n_meta, np.int32), primary_category=list(blank),
        journal_ref=[None] * n_meta, citations=np.full(n_meta, -1, np.int64),
        theorem_name=["Theorem" if i < 4096 else "" for i in range(n_meta)],
        slogan=texts + [""] * (n_meta - 4096),
        theorem_body=[f"$x_{{{i}}}$ is bounded." if i < 4096 else "" for i in range(n_meta)],
    )
    engine = SearchEngine(index, meta=meta, rescore_vectors=corpus, device=dev)
    qd = []
    for s in range(5):
        qq = torch.randn((1024, D), generator=torch.Generator(device=dev).manual_seed(1000 + s), device=dev)
        qd.append(qq / qq.norm(dim=1, keepdim=True))
    _, oracle = exact_topk(torch.cat(qd), corpus, k=10, device=dev)
    scans0 = mips_g_launches.n
    recalls = []
    for s in range(5):
        _, ids = engine.search_vectors(qd[s], k=10)
        recalls.append(recall_vs_exact(ids, oracle[s * 1024 : (s + 1) * 1024], k=10))
    emit("index", rows=NC, dim=D, build_s=round(build_s, 3), global_scale=index.global_scale,
         speed_ok=engine._speed_ok, row_block=engine.row_block,
         recall_draws=recalls, recall_min=min(recalls), scan_launches=mips_g_launches.n - scans0,
         index_bytes=index.vectors.numel(), rescore_bytes=engine._rescore_device.numel() * 2)
    if not (engine._speed_ok and min(recalls) >= 0.99 and mips_g_launches.n - scans0 >= 5):
        raise AssertionError("index phase failed")

    # ---- 7. serving ----
    sched = BatchScheduler(engine, max_batch=256, encode_fn=encoder.encode_device)
    service = SearchService(engine, encoder.encode, scheduler=sched)
    direct = SearchService(engine, encoder.encode)
    server = SearchServer(service, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}/search"
    qtexts = [texts[(37 * i) % 4096] for i in range(128)]

    def post(text):
        req = urllib.request.Request(
            url, data=json.dumps({"query": text, "top_k": 10}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        with ThreadPoolExecutor(64) as ex:
            # one warm round first: each new batch size's first pass pays
            # one-time set-up (pinned host blocks, GEMM algorithm choice)
            list(ex.map(post, qtexts))
            sched.reset_traces()
            warm = sched.stats()
            t0 = time.perf_counter()
            answers = list(ex.map(post, qtexts))
            serve_s = time.perf_counter() - t0
        stats = sched.stats()
        n_batches = stats["batches"] - warm["batches"]
        n_queries = stats["queries"] - warm["queries"]
    finally:
        server.stop()
        sched.shutdown()
    main_launches = {"mips_g_scan": mips_g_launches.n, "qknorm_rope_attention": attention_launches.n}
    codes_ok = all(code == 200 for code, _ in answers)
    joined = all(
        len(body["results"]) == 10 and all("theorem_slogan" in r and "paper_url" in r for r in body["results"])
        for _, body in answers)
    overlaps, self_hits = [], 0
    for text, (_, body) in zip(qtexts, answers):
        got = [r["doc_id"] for r in body["results"]]
        want = [r["doc_id"] for r in direct.search_and_display(text)]
        overlaps.append(len(set(got) & set(want)) / 10)
        self_hits += texts.index(text) == got[0]
    emit("serve", requests=len(answers), all_200=codes_ok, metadata_joined=joined,
         overlap10_mean=float(np.mean(overlaps)), overlap10_min=float(np.min(overlaps)),
         self_top1=self_hits, wall_s=round(serve_s, 3),
         batches=n_batches, avg_batch=n_queries / max(n_batches, 1),
         latency_ms=stats.get("latency_ms"), stages_ms={
             k: v for k, v in stats.get("stages_ms", {}).items() if k != "worst_batches"},
         launches=main_launches)
    if not (codes_ok and joined and np.mean(overlaps) >= 0.9 and len(answers) >= 64):
        raise AssertionError("serve phase failed")
    if min(main_launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {main_launches}")

    # ---- 8. B1 on the engine's own index, and times at the path's shapes
    # (not counted as main-path launches) ----
    qb = qd[0]
    n_valid, rb = engine.n_valid, engine.row_block
    m = auto_merge_tiles(D, rb // 128, engine.padded_rows // rb)
    q8, qs = quantize_queries(qb)
    ck = mips_g_scan(q8, engine.vectors, n_valid, rb, m)
    cp = mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m)
    err = int((ck.long() - cp.long()).abs().max())
    b1_err = max(b1_err, err)
    emit("b1", n_valid=n_valid, merge_tiles=m, shape=list(ck.shape),
         bit_equal=torch.equal(ck, cp), max_abs_err=err)
    if not torch.equal(ck, cp):
        raise AssertionError("B1 kernel disagrees with its plain version on the 1M index")
    del ck, cp
    scan_k = cuda_ms(lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m), 10)
    scan_p = cuda_ms(lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m), 3)

    def pipeline(scan):
        def run():
            a8, sc = quantize_queries(qb)
            cand = scan(a8, engine.vectors, n_valid, rb, m)
            _, li = select_candidates(cand, sc, engine._global_scale, 40, rb, m)
            return device_rescore(qb, li, engine._rescore_device, n_valid, k=10)
        return run

    pipe_k = cuda_ms(pipeline(mips_g_scan), 10)
    pipe_p = cuda_ms(pipeline(mips_g_scan_plain), 3)
    ids_mask, _ = encoder._prep_batch(texts[:512], [encoder.tokenizer.tokenize(t) for t in texts[:512]],
                                      list(range(512)))
    t = torch.from_numpy(ids_mask).to(dev)
    with torch.inference_mode():
        enc_k = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, fused="on"), 5)
        enc_p = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, fused="plain"), 5)
    S = int(t.shape[2])
    qa = torch.randn((512, S, H * DH), generator=g, device=dev).to(torch.bfloat16)
    ka = torch.randn((512, S, HK * DH), generator=g, device=dev).to(torch.bfloat16)
    va = torch.randn((512, S, HK * DH), generator=g, device=dev).to(torch.bfloat16)
    cos = torch.randn((512, S, DH // 2), generator=g, device=dev)
    sin = torch.randn((512, S, DH // 2), generator=g, device=dev)
    msk = t[1].to(torch.int32).contiguous()
    wq = torch.ones(DH, device=dev)
    kwargs = dict(num_heads=H, num_kv_heads=HK, head_dim=DH, eps=1e-6, causal=True)
    att_k = cuda_ms(lambda: fused_qknorm_rope_attention(qa, ka, va, wq, wq, cos, sin, msk, **kwargs), 20)
    att_p = cuda_ms(lambda: fused_qknorm_rope_attention_plain(
        qa, ka, va, wq, wq, cos, sin, msk, scale=1.0 / np.sqrt(DH), **kwargs), 5)
    emit("times", gpu=gpu,
         scan_ms={"kernel": scan_k, "plain": scan_p, "shape": [1024, NC, D]},
         scan_rescore_ms_per_batch={"kernel": pipe_k, "plain": pipe_p, "qps_kernel": 1024 / pipe_k * 1e3},
         encoder_forward_ms={"kernel": enc_k, "plain": enc_p, "shape": [512, S]},
         attention_ms={"kernel": att_k, "plain": att_p, "shape": [512, S, H, HK, DH]},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         total_s=round(time.perf_counter() - t_start, 1))

    for name, fn in (
        ("encoder_forward_512x64", lambda: encode_pooled(params, t[0], t[1], cfg)),
        ("scan_rescore_b1024", pipeline(mips_g_scan)),
    ):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
        emit("profile", what=name, gpu=gpu, top_device_us=[
            [e.key[:60], round(e.self_device_time_total, 1), e.count] for e in rows])

    print(gpu)
    print(json.dumps({"kernels": [
        {"name": "mips_g_scan", "route": "cuda", "source": "theoremsearch_tpu_torch/csrc/mips_g.cu",
         "replaces": "theoremsearch_tpu/kernels/mips.py:300", "launches": main_launches["mips_g_scan"],
         "max_abs_err": b1_err, "ms": scan_k, "plain_ms": scan_p},
        {"name": "qknorm_rope_attention", "route": "cuda",
         "source": "theoremsearch_tpu_torch/csrc/attention.cu",
         "replaces": "theoremsearch_tpu/kernels/attention.py:60",
         "launches": main_launches["qknorm_rope_attention"],
         "max_abs_err": b2_err, "ms": att_k, "plain_ms": att_p},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
