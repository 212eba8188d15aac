#!/usr/bin/env python3
"""Time the port's encoder kernels and forwards of one checkout on the card.

    python tools/torch_kernel_ab.py --root DIR [--label NAME]

Imports `theoremsearch_tpu_torch` from DIR (a checkout of the repository;
its kernels are built from DIR's own sources at first use) and prints one
JSON line of CUDA-event times, in ms, at the encoder's serving shape
(B, S) = (512, 64) with ragged masks from a fixed seed:

- B2 (`fused_qknorm_rope_attention`), qwen form (16/8 heads of 128,
  causal) and gemma form (3/1 heads of 256, bidirectional), at (512, 64)
  and at (64, 64) with full masks;
- B3 and B4 in both forms on one full-width layer of random int8 weights;
- B1 (`mips_g_scan`) on a 1,048,576 x 1024 int8 corpus (row block 4096,
  merge tiles 4: the speed engine's geometry) at B = 1024, 64 and 8:
  unmasked, with a year mask (a contiguous 30% of the ids, as the serving
  benchmark's year filter lays them out) and with 32 mask rows per query
  (16 year windows, 8 category stripes, 8 citation bands, random ids);
  each as device time (launches queued behind a sleep kernel) and as the
  wrapper's back-to-back time (`..._back_to_back`), which also counts the
  host work of the wrapper where it outlasts the card;
- B5 (`mips_topk`, the exact route's scan) on a 1,048,576 x 1024
  per-row int8 corpus at k = 40: B = 512, 64 and 8, B = 512 with a year
  bias (0 on a contiguous 30% of the ids, -inf elsewhere) and B = 512 at
  k = 400; the same corpus in bf16 at B = 512, k = 40; a 262,144 x 1024
  f32 corpus at B = 512, k = 10; each as device time and back to back;
- the exact route end to end (`SearchEngine.search_vectors` at B = 512,
  k = 10, on a 1,048,576 x 1024 per-row int8 index with its bf16 host
  rescore copy: B5, then the rescore on the host), unfiltered and under
  the serving benchmark's year filter (its metadata: years in contiguous
  id blocks), wall ms a batch over 5 batches after a warm one;
- B7 (`fused_qknorm_rope_attention_bwd`) at the training shape (64, 64,
  16, 8, 128) with full masks, and the full-width qwen train step "on"
  (B2 forward, B7 backward) at 64 pairs x 64 tokens (median of 8 steps
  after 2 warm ones);
- the four full-width encoder forwards (`encode_pooled`): Qwen3-0.6B-
  class (`EncoderConfig()`) and embeddinggemma-300m-class
  (`GemmaEncoderConfig()`), bf16 and int8 whole layers.

Every input is made from fixed seeds, so two checkouts timed in one call
(parent, change, change, parent) see the same data. `--only b5,b7` times
those sections alone (b2, b3b4, b1, b5, exact, b7, train, fwd). Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def queued_ms(fn, iters: int) -> float:
    """Device time per call, the calls queued behind a sleep kernel (a
    wrapper whose host work outlasts its device work would otherwise be
    timed by the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose theoremsearch_tpu_torch to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--only", default="b2,b3b4,b1,b5,exact,b7,train,fwd",
                    help="comma-separated sections to time")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from theoremsearch_tpu_torch.core.config import EncoderConfig, GemmaEncoderConfig
    from theoremsearch_tpu_torch.encoder import gemma as gemma_mod
    from theoremsearch_tpu_torch.encoder.model import (
        _rope_tables, encode_pooled, init_params, quantize_params_int8,
    )
    from theoremsearch_tpu_torch.index.quant import quantize_global_int8
    from theoremsearch_tpu_torch.kernels import _build
    from theoremsearch_tpu_torch.kernels.attention import fused_qknorm_rope_attention
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        fused_attn_int8_layer, fused_attn_int8_layer_gemma, fused_mlp_int8_layer, kernel_layout,
    )
    from theoremsearch_tpu_torch.index.quant import quantize_int8
    from theoremsearch_tpu_torch.kernels.mips import mips_g_scan, mips_topk, quantize_queries
    from theoremsearch_tpu_torch.utils.device import gpu_name_power

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_build = time.perf_counter()
    _build.load()
    res = {"label": args.label or args.root, "gpu": gpu_name_power(),
           "build_s": round(time.perf_counter() - t_build, 1)}
    g = torch.Generator(device=dev).manual_seed(0)
    B, S = 512, 64
    lens = torch.randint(12, S + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32)
    pos = torch.clamp(mask.cumsum(1) - 1, min=0)

    # B2, both forms
    if "b2" in only:
        forms = {"qwen": (16, 8, 128, True, 128 ** -0.5, 1e6),
                 "gemma": (3, 1, 256, False, 256 ** -0.5, 1e4)}
        for name, (h, hk, dh, causal, scale, theta) in forms.items():
            q = (torch.randn((B, S, h * dh), generator=g, device=dev) * 2).to(torch.bfloat16)
            k = (torch.randn((B, S, hk * dh), generator=g, device=dev) * 2).to(torch.bfloat16)
            v = torch.randn((B, S, hk * dh), generator=g, device=dev).to(torch.bfloat16)
            w = 1.0 + 0.1 * torch.randn((2, dh), generator=g, device=dev)
            cos, sin = _rope_tables(pos, dh, theta)
            kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=causal, scale=scale)
            res[f"b2_{name}_512x64"] = cuda_ms(
                lambda: fused_qknorm_rope_attention(q, k, v, w[0], w[1], cos, sin, mask, **kw), 20)
            full = torch.ones((64, S), dtype=torch.int32, device=dev)
            c64, s64 = _rope_tables(torch.clamp(full.cumsum(1) - 1, min=0), dh, theta)
            q64, k64, v64 = q[:64].contiguous(), k[:64].contiguous(), v[:64].contiguous()
            res[f"b2_{name}_64x64"] = cuda_ms(
                lambda: fused_qknorm_rope_attention(q64, k64, v64, w[0], w[1], c64, s64, full, **kw), 50)
            del q, k, v

    # B3 and B4 on one full-width layer, both forms
    if "b3b4" in only:
        cfg = EncoderConfig(vocab_size=512, num_layers=1)
        p1 = init_params(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
        layer, lq = p1["layers"][0], kernel_layout(quantize_params_int8(p1))[0]
        x = torch.randn((B, S, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        rope = _rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        gcfg = GemmaEncoderConfig(vocab_size=512, num_layers=1)
        gg = torch.Generator(device=dev).manual_seed(3)
        gp1 = gemma_mod.init_params(gcfg, gg, device=dev)
        glayer = gp1["layers"][0]
        for t_ in glayer.values():          # the (1 + w) norm weights off zero
            if t_.ndim == 1:
                t_ += 0.1 * torch.randn(t_.shape, generator=gg, device=dev)
        glq = kernel_layout(gemma_mod.quantize_params_int8({"layers": [glayer]}))[0]
        gx = torch.randn((B, S, gcfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        grope = gemma_mod._rope_tables(pos, gcfg.head_dim, gcfg.rope_local_theta)
        with torch.inference_mode():
            res["b3_qwen"] = cuda_ms(lambda: fused_attn_int8_layer(x, layer, lq, mask, rope, cfg), 20)
            res["b4_qwen"] = cuda_ms(lambda: fused_mlp_int8_layer(
                x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"]), 20)
            res["b3_gemma"] = cuda_ms(
                lambda: fused_attn_int8_layer_gemma(gx, glayer, glq, mask, grope, gcfg), 20)
            res["b4_gemma"] = cuda_ms(lambda: fused_mlp_int8_layer(
                gx, 1.0 + glayer["pre_mlp_norm"], glq["w_gate"], glq["w_up"], glq["w_down"],
                1.0 + glayer["post_mlp_norm"], act="gelu_tanh"), 20)
        del p1, gp1, layer, lq, glayer, glq, x, gx

    # B1 on the speed engine's geometry
    if "b1" in only:
        n, d, rb, m = 1 << 20, 1024, 4096, 4
        codes = torch.empty((n, d), dtype=torch.int8, device=dev)
        for lo in range(0, n, 1 << 18):
            xc = torch.randn((1 << 18, d), generator=g, device=dev)
            codes[lo:lo + (1 << 18)] = quantize_global_int8(xc / xc.norm(dim=1, keepdim=True))[0]
        q8, _ = quantize_queries(torch.randn((1024, d), generator=g, device=dev))
        rows = torch.arange(n, device=dev)
        year = ((rows >= int(0.4 * n)) & (rows < int(0.7 * n))).to(torch.int8)
        yr = rows // (n // 30)
        stack = ([(yr >= j) & (yr < j + 6) for j in range(1, 17)]
                 + [rows % 22 == c for c in range(8)]
                 + [(rows % 1000 >= 50 * j) & (rows % 1000 <= 50 * j + 120) for j in range(8)])
        gm = torch.stack(stack).to(torch.int8)
        gids = torch.randint(0, 32, (1024,), generator=g, device=dev, dtype=torch.int32)
        for bs in (1024, 64, 8):
            qs_, ids_ = q8[:bs].contiguous(), gids[:bs].contiguous()
            for form, kw_ in (("", {}), ("year_mask_", {"mask": year}),
                              ("gmask32_", {"gmasks": gm, "mask_ids": ids_})):
                def scan(qs_=qs_, kw_=kw_):
                    return mips_g_scan(qs_, codes, n, rb, m, **kw_)
                res[f"b1_{form}{bs}x1M"] = queued_ms(scan, 20)
                res[f"b1_{form}{bs}x1M_back_to_back"] = cuda_ms(scan, 20)
        del codes, xc, gm, stack

    # B5 on the exact route's corpora (per-row int8 at 1M x 1024, its bf16
    # copy, a 262k x 1024 f32 corpus)
    if "b5" in only:
        n, d = 1 << 20, 1024
        codes = torch.empty((n, d), dtype=torch.int8, device=dev)
        scales = torch.empty((n,), dtype=torch.float32, device=dev)
        xbf = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
        for lo in range(0, n, 1 << 18):
            xc = torch.randn((1 << 18, d), generator=g, device=dev)
            xc /= xc.norm(dim=1, keepdim=True)
            codes[lo:lo + (1 << 18)], scales[lo:lo + (1 << 18)] = quantize_int8(xc, device=dev)
            xbf[lo:lo + (1 << 18)] = xc.to(torch.bfloat16)
        xf = xc                                        # the last 262k rows, f32
        qf = torch.randn((512, d), generator=g, device=dev)
        qf /= qf.norm(dim=1, keepdim=True)
        q8 = quantize_queries(qf)[0]
        rows = torch.arange(n, device=dev)
        year = torch.where((rows >= int(0.4 * n)) & (rows < int(0.7 * n)), 0.0, float("-inf"))
        cases = {
            "b5_int8_512x1M_k40": (q8, codes, scales, None, 40),
            "b5_int8_64x1M_k40": (q8[:64].contiguous(), codes, scales, None, 40),
            "b5_int8_8x1M_k40": (q8[:8].contiguous(), codes, scales, None, 40),
            "b5_int8_year_512x1M_k40": (q8, codes, scales, year, 40),
            "b5_int8_512x1M_k400": (q8, codes, scales, None, 400),
            "b5_bf16_512x1M_k40": (qf.to(torch.bfloat16), xbf, None, None, 40),
            "b5_f32_512x262k_k10": (qf, xf, None, None, 10),
        }
        for name, (qk, cc, sc, bi, k_) in cases.items():
            def exact(qk=qk, cc=cc, sc=sc, bi=bi, k_=k_):
                return mips_topk(qk, cc, sc, cc.shape[0], bi, k_)
            res[name] = queued_ms(exact, 10)
            res[f"{name}_back_to_back"] = cuda_ms(exact, 10)
        del codes, scales, xbf, xf, xc, cases

    # the exact route end to end on a per-row int8 index
    if "exact" in only:
        import numpy as np

        from theoremsearch_tpu_torch.core.config import IndexConfig
        from theoremsearch_tpu_torch.index.flat import FlatIndex
        from theoremsearch_tpu_torch.search.engine import SearchEngine
        from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
        from theoremsearch_tpu_torch.serve.app import _filters_from_ui

        n, d = 1 << 20, 1024
        corpus = np.empty((n, d), np.float32)
        for lo in range(0, n, 1 << 17):
            xc = torch.randn((1 << 17, d), generator=g, device=dev)
            corpus[lo:lo + (1 << 17)] = (xc / xc.norm(dim=1, keepdim=True)).cpu().numpy()
        index = FlatIndex.build(corpus, config=IndexConfig(dtype="int8"), device=dev)
        meta = CorpusMetadata(
            paper_id=[f"p{i}" for i in range(n)], paper_title=["T"] * n,
            authors=[[] for _ in range(n)], link=["https://arxiv.org/abs/x"] * n,
            year=(1995 + np.arange(n) // (n // 30)).astype(np.int32),
            primary_category=["math.AG"] * n, journal_ref=[None] * n,
            citations=np.zeros(n, np.int64), theorem_name=[""] * n, slogan=[""] * n,
            theorem_body=[""] * n)
        host_bf16 = torch.from_numpy(corpus).to(torch.bfloat16)   # the host rescore copy
        eng = SearchEngine(index, meta=meta, rescore_vectors=host_bf16, device=dev)
        del corpus
        year = _filters_from_ui({"year_range": [2005, 2013]})
        qs = [torch.randn((512, d), generator=g, device=dev) for _ in range(6)]
        for name, kw in (("exact_b512_unfiltered", {}), ("exact_b512_year", {"filters": year})):
            eng.search_vectors(qs[0], k=10, **kw)
            t0 = time.perf_counter()
            for q_ in qs[1:]:
                eng.search_vectors(q_, k=10, **kw)
            res[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        del eng, index, meta, host_bf16

    # B7 at the training shape, full masks
    if "b7" in only:
        from theoremsearch_tpu_torch.kernels.attention import fused_qknorm_rope_attention_bwd

        tb, ts, th, thk, tdh = 64, 64, 16, 8, 128
        qa = (torch.randn((tb, ts, th * tdh), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        ka = (torch.randn((tb, ts, thk * tdh), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        va = (torch.randn((tb, ts, thk * tdh), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        ga = (torch.randn((tb, ts, th * tdh), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        w7 = 1.0 + 0.1 * torch.randn((2, tdh), generator=g, device=dev)
        full = torch.ones((tb, ts), dtype=torch.int32, device=dev)
        c7, s7 = _rope_tables(torch.clamp(full.cumsum(1) - 1, min=0), tdh, 1e6)
        kw7 = dict(num_heads=th, num_kv_heads=thk, head_dim=tdh, eps=1e-6, causal=True)
        res["b7_64x64"] = cuda_ms(lambda: fused_qknorm_rope_attention_bwd(
            qa, ka, va, w7[0], w7[1], c7, s7, full, ga, **kw7), 50)
        del qa, ka, va, ga

    # the qwen train step "on" at 64 pairs x 64 tokens
    if "train" in only:
        from theoremsearch_tpu_torch.core.config import TrainConfig
        from theoremsearch_tpu_torch.train.contrastive import init_train_state, make_train_step

        tb, ts = 64, 64
        full = torch.ones((tb, ts), dtype=torch.int32, device=dev)
        tcfg = TrainConfig(batch_size=64, seq_len=64, learning_rate=2e-5, temperature=0.05)
        trc = EncoderConfig(max_seq_len=64)
        st = init_train_state(trc, tcfg, device=dev)
        step = make_train_step(trc, tcfg, fused="on")
        tq = torch.randint(3, trc.vocab_size, (tb, ts), generator=g, device=dev, dtype=torch.int32)
        tp = tq.clone()
        tp[:, 2:6] = torch.randint(3, trc.vocab_size, (tb, 4), generator=g, device=dev, dtype=torch.int32)
        step_ms = []
        for i in range(10):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            st, _ = step(st, tq, full, tp, full)
            ev[1].record()
            ev[1].synchronize()
            if i >= 2:
                step_ms.append(ev[0].elapsed_time(ev[1]))
        res["train_step_on_64x64"] = sorted(step_ms)[len(step_ms) // 2]
        del st, step
        torch.cuda.empty_cache()

    # the four full-width forwards
    if "fwd" in only:
        ecfg, egcfg = EncoderConfig(), GemmaEncoderConfig()
        params = init_params(ecfg, torch.Generator(device=dev).manual_seed(1), device=dev)
        ql = kernel_layout(quantize_params_int8(params))
        ids = torch.randint(3, 1000, (B, S), generator=g, device=dev) * mask
        gparams = gemma_mod.init_params(egcfg, torch.Generator(device=dev).manual_seed(4), device=dev)
        gr = torch.Generator(device=dev).manual_seed(5)
        for lay in gparams["layers"]:
            for t_ in lay.values():
                if t_.ndim == 1:
                    t_ += 0.1 * torch.randn(t_.shape, generator=gr, device=dev)
        gql = kernel_layout(gemma_mod.quantize_params_int8(gparams))
        with torch.inference_mode():
            res["fwd_qwen_bf16"] = cuda_ms(lambda: encode_pooled(params, ids, mask, ecfg), 5)
            res["fwd_qwen_int8"] = cuda_ms(lambda: encode_pooled(
                params, ids, mask, ecfg, qlayers=ql, fused_layers=True), 5)
            res["fwd_gemma_bf16"] = cuda_ms(lambda: gemma_mod.encode_pooled(gparams, ids, mask, egcfg), 5)
            res["fwd_gemma_int8"] = cuda_ms(lambda: gemma_mod.encode_pooled(
                gparams, ids, mask, egcfg, qlayers=gql, fused_layers=True), 5)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
