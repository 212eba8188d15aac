#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py [--ivf-slab-rows R]

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
 4b. b3b4    the whole-layer int8 kernels B4 (MLP block) and B3
             (attention block) vs their plain versions on one full-width
             layer of random weights quantized by quantize_params_int8:
             (B, S) = (512, 64) with the slogans' ragged masks, (64, 32),
             (64, 128), and an MLP input of 70 * 128 + 70 rows; the norm +
             quant stage's int8 codes bit-equal.
 4c. b6      the IVF probe-major chunk scan kernel vs its plain version,
             bit-equal raw scores and query scales, at (B, P, R, D) =
             (8, 526, 256, 1024), (16, 526, 256, 1024), (64, 1500, 256,
             1024), (13, 5, 128, 1024), (8, 3, 512, 1024), the uids ending
             in repeats of the empty fill chunk.
 5. encoder  full-width Qwen3-0.6B-class encoder (28 layers, random bf16
             weights from a seeded generator): kernel path vs plain path
             cosine, then 4,096 slogans through BatchedEncoder.
 5b. encoder_int8  the same encoder in int8 (w8a8) serving mode, every
             layer on B3 and B4: kernel vs plain pooled cosine, the plain
             path at B 256 vs 512 (the stack's own floor), int8 vs bf16,
             then 4,096 slogans through BatchedEncoder(quant="int8").
 6. index    1,048,576 x 1024 corpus (random unit rows; the first 4,096
             replaced by the encoder's embeddings of synthetic slogans),
             int8-global FlatIndex + bf16 rescore copy, metadata laid out
             as the serving benchmark's (tools/serve_bench.py), SearchEngine
             speed path, min recall@10 over 5 draws of 1024 vs the fp32
             exact oracle.
 7. serve    SearchService + BatchScheduler + SearchServer on 127.0.0.1,
             128 POST /search from 64 client threads after one warm
             round of the same, overlap@10 vs the direct path.
 7b. serve_int8  phase 7 with the int8 encoder behind the scheduler:
             overlap@10 vs the direct path with the same encoder, B3 and
             B4 launched on the served path.
 8. b1m      B1's mask and gmask forms vs plain at the phase-3 shapes
             (run right after phase 3, on its corpus)
             (contiguous range, striped category, 3 survivors, none;
             gmasks G=8 and G=32 with random mask_ids): bit-equal
             candidates; then on the 1M index: unmasked, a year mask and
             the 36-signature stack.
 9. filtered the speed engine on the 1M index under the serving
             benchmark's 3- and 36-signature mixes at B=512: min
             recall@10 vs the fp32 oracle over the passing rows, every id
             passes its filter, the broad filter on the over-fetch route,
             a mixed 36-signature batch (grouped, split 32 + 4) equal to
             per-signature dispatch.
10. b5       exact top-k kernel vs plain on the 1M per-row int8 corpus
             and 262,144 x 1024 bf16 / f32 corpora, B 8 and 512, k 10,
             40, 400, with and without a 0/-inf bias.
11. exact    SearchEngine on the 1M per-row int8 index with a bf16 host
             rescore copy (kernel B5), unfiltered and year-filtered, min
             recall@10 over 5 draws of 512.
12. serve_filtered  256 POST /search with filters from the 36-signature
             mix, 64 client threads, after a warm round: all 200, every
             result passes its filter, overlap@10 vs the direct path,
             grouped scans carrying more than one signature.
13. times    kernel / plain / bound times at the main path's shapes (B1
             unmasked, mask and gmask G=32 at B=1024 on 1M; B5 at B=512
             on 1M int8 per-row and bf16; B2, B3 and B4 at (512, 64); B6
             at the ivf phase's B=8 search and the b6 shapes, as device
             time from the profiler), the bf16 and int8 encoder
             forwards, and torch.profiler tables of one bf16 and one int8
             encoder forward, one scan + rescore batch, one filtered
             grouped batch and one B=8 IVF search.
14. ivf_build  a 1,048,576 x 1024 clustered corpus made on the card (4,096
             unit centres, rows = centre + 1.5/sqrt(D) gaussian noise,
             renormalized: the reference's "overlap" geometry; rows 0-4095
             replaced by the slogan embeddings), IVFIndex.build with 4,096
             lists, int8, the bf16 rescore copy and the build's slab rule
             (99th-percentile list size rounded up to a power-of-two
             multiple of 128; --ivf-slab-rows R sets R instead): seconds
             for k-means, assignment and the rest, spill and relocated
             rows, bytes.
15. ivf      calibrate_nprobe(gate=0.99) on the card; recall@10 at B=8,
             min over 5 draws of 128 centre + noise queries vs the fp32
             oracle, at nprobe 16, 32, 64 and the calibrated value (which
             must hold 0.99); the probe-major search with B6 swapped for
             its plain version gives equal ids; device_searcher latency at
             B=8 and 16 beside the flat speed path's on the same corpus.
16. serve_ivf  text -> BatchedEncoder -> BatchScheduler -> SearchEngine(
             flat, ivf_index=...) -> SearchService -> HTTP, 128 requests
             from 8 client threads (batches <= 8, the IVF route): all 200
             with metadata, IVF route taken, overlap@10 vs the direct path.

Each path (phases 5-7, 7b, 9, 11, 12, 15, 16) runs with every launch counter set to
0 just before it and read just after; kernel-vs-plain comparisons run
outside those windows, so the `launches` in the kernels line count only
launches made by the main paths (BatchedEncoder, SearchEngine, the HTTP
stack).
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




# The serving benchmark's filtered traffic (tools/serve_bench.py): its
# metadata layout and its 3- and 36-signature mixes, copied here as the
# UI filter dicts that POST /search takes.
CATS = [f"math.{c}" for c in
        "AG AT AP CA CO CT DG DS FA GM GN GR GT HO KT LO MG NT OA PR RA RT".split()]
MIX3 = [{"year_range": [2005, 2013]}, {"tags": ["math.NT", "math.AG", "math.CO"]},
        {"journal_status": "Preprint Only"}]
MIX36 = ([{"year_range": [1996 + j, 2001 + j]} for j in range(16)]
         + [{"tags": [f"math.{c}"]} for c in ("AG", "NT", "CO", "PR", "CA", "DG", "FA", "GT")]
         + [{"citation_range": [50 * j, 50 * j + 120]} for j in range(8)]
         + [{"year_range": [2004, 2015], "tags": ["math.AG", "math.NT"]},
            {"journal_status": "Journal Article", "citation_range": [10, 500]},
            {"year_range": [2010, 2020], "journal_status": "Preprint Only"},
            {"tags": ["math.CO"], "citation_range": [0, 99]}])


def bench_metadata(n: int, texts: list[str], cls):
    """Years in contiguous id blocks (a year range is a contiguous id
    mask), categories striped, journal status alternating, citations
    i % 1000; the first len(texts) rows carry the slogans."""
    m = len(texts)
    return cls(
        paper_id=[f"p{i}" for i in range(n)],
        paper_title=[f"Paper {i}" if i < m else "T" for i in range(n)],
        authors=[[] for _ in range(n)],
        link=[f"https://arxiv.org/abs/2401.{i:05d}" if i < m else "https://arxiv.org/abs/x"
              for i in range(n)],
        year=(1995 + np.arange(n) // max(1, n // 30)).astype(np.int32),
        primary_category=[CATS[i % len(CATS)] for i in range(n)],
        journal_ref=[None, "J. Math."] * (n // 2),
        citations=np.arange(n, dtype=np.int64) % 1000,
        theorem_name=["Theorem" if i < m else "" for i in range(n)],
        slogan=texts + [""] * (n - m),
        theorem_body=[f"$x_{{{i}}}$ is bounded." if i < m else "" for i in range(n)],
    )


# H100 SXM data-sheet peaks (dense): what `bound_ms` divides by
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type
    (`ops` maps a type to its count; the times of the types add)."""
    tb = nbytes / HBM_BYTES_S
    to = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return {"bound_ms": 1e3 * max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def agreement(out, ref) -> tuple[float, float, float]:
    """(cosine, max abs difference, max |ref|) of two tensors, in f64."""
    a, b = out.double().flatten(), ref.double().flatten()
    return float(a @ b / (a.norm() * b.norm())), float((a - b).abs().max()), float(b.abs().max())


def topk_agree(sk, ik, sp, ip, exact: bool) -> tuple[bool, float]:
    """B5 kernel vs plain: int8 (exact sums) bit-equal scores and ids;
    bf16/f32 (f32 sums in another order) scores within 1e-5 absolute and
    ids equal except where a neighbouring score is within 1e-5."""
    import torch

    fin = torch.isfinite(sp)
    err = float((sk[fin] - sp[fin]).abs().max()) if bool(fin.any()) else 0.0
    if exact:
        return torch.equal(sk, sp) and torch.equal(ik, ip), err
    near = torch.zeros_like(fin)
    gap = (sp[:, 1:] - sp[:, :-1]).abs() <= 1e-5
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True                  # the k-th slot's neighbour is outside the list
    ok = torch.equal(fin, torch.isfinite(sk)) and err <= 1e-5 and torch.equal(ik[~near], ip[~near])
    return ok, err


def unit_rows(n: int, d: int, seed: int, dev):
    import torch

    x = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return x / x.norm(dim=1, keepdim=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ivf-slab-rows", type=int, default=None,
                    help="slab rows of the 1M IVF index (default: IVFIndex.build's rule, the "
                         "99th-percentile list size rounded up to a power-of-two multiple of 128)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.model import (
        _rope_tables, encode_pooled, init_params, quantize_params_int8,
    )
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer
    from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
    from theoremsearch_tpu_torch.eval.oracle import exact_topk
    from theoremsearch_tpu_torch.index import ivf as ivf_mod
    from theoremsearch_tpu_torch.index.flat import FlatIndex
    from theoremsearch_tpu_torch.index.ivf import IVFIndex, calibrate_nprobe
    from theoremsearch_tpu_torch.index.quant import quantize_global_int8
    from theoremsearch_tpu_torch.kernels import _build
    from theoremsearch_tpu_torch.kernels.attention import (
        attention_launches, fused_qknorm_rope_attention, fused_qknorm_rope_attention_plain,
    )
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        attn_int8_launches, fused_attn_int8_layer, fused_attn_int8_layer_plain,
        fused_mlp_int8_layer, fused_mlp_int8_layer_plain, kernel_layout, mlp_int8_launches,
        rmsnorm_quant_plain,
    )
    from theoremsearch_tpu_torch.kernels.mips import (
        auto_merge_tiles, device_rescore, ivf_probe_scores, ivf_probe_scores_plain,
        ivf_scores_launches, mips_g_gmask_launches, mips_g_launches, mips_g_mask_launches,
        mips_g_scan, mips_g_scan_plain, mips_topk, mips_topk_launches, mips_topk_plain,
        quantize_queries, select_candidates,
    )
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from theoremsearch_tpu_torch.serve.app import SearchService, _filters_from_ui
    from theoremsearch_tpu_torch.serve.http_api import SearchServer
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler
    from theoremsearch_tpu_torch.utils.device import gpu_name_power, require_cuda
    from torch.profiler import ProfilerActivity, profile

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_power()
    t_start = time.perf_counter()
    counters = {
        "mips_g_scan": mips_g_launches, "mips_g_scan_mask": mips_g_mask_launches,
        "mips_g_scan_gmask": mips_g_gmask_launches, "mips_topk": mips_topk_launches,
        "qknorm_rope_attention": attention_launches,
        "fused_attn_int8_layer": attn_int8_launches, "fused_mlp_int8_layer": mlp_int8_launches,
        "ivf_probe_scores": ivf_scores_launches,
    }
    main_launches = dict.fromkeys(counters, 0)

    def path_start() -> None:
        for c in counters.values():
            c.reset()

    def path_end() -> dict:
        got = {name: c.n for name, c in counters.items()}
        for name, n in got.items():
            main_launches[name] += n
        return got

    # ---- 1. env ----
    emit("env", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in _build.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=_build.build_seconds, ptxas=regs)

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
    err_of = dict.fromkeys(counters, 0.0)

    def check_b1(key, n_valid, m, q8_, qs_, gs_, codes_, rb, **masks):
        """One B1 form, kernel vs plain: bit-equal candidates and equal
        decoded (scores, ids)."""
        ck = mips_g_scan(q8_, codes_, n_valid, rb, m, **masks)
        cp = mips_g_scan_plain(q8_, codes_, n_valid, rb, m, **masks)
        torch.cuda.synchronize()
        err = int((ck.long() - cp.long()).abs().max())
        err_of[key] = max(err_of[key], err)
        sk, ik = select_candidates(ck, qs_, gs_, 40, rb, m)
        sp, ip = select_candidates(cp, qs_, gs_, 40, rb, m)
        ok = torch.equal(ck, cp) and torch.equal(sk, sp) and torch.equal(ik, ip)
        return ok, err, list(ck.shape)

    for n_valid in (N, N - 1000):
        for m in (1, 4):
            ok, err, shape = check_b1("mips_g_scan", n_valid, m, q8, qs, gscale, codes, RB)
            emit("b1", n_valid=n_valid, merge_tiles=m, shape=shape, bit_equal=ok, max_abs_err=err)
            if not ok:
                raise AssertionError(f"B1 kernel disagrees with its plain version (n_valid={n_valid}, M={m})")

    # ---- 8a. B1's mask and gmask forms vs plain at the same shapes ----
    gcpu = torch.Generator().manual_seed(5)
    one_masks = {"range": torch.zeros(N, dtype=torch.int8), "stripe": torch.zeros(N, dtype=torch.int8),
                 "three": torch.zeros(N, dtype=torch.int8), "none": torch.zeros(N, dtype=torch.int8)}
    one_masks["range"][N // 5 : N // 2] = 1           # a year range over id-ordered rows
    one_masks["stripe"][3::22] = 1                    # one category of 22
    one_masks["three"][[17, N // 3, N - 2000]] = 1
    stack = []
    for i in range(32):
        kind = i % 3
        mk = torch.zeros(N, dtype=torch.int8)
        if kind == 0:
            lo = int(torch.randint(0, N // 2, (1,), generator=gcpu))
            mk[lo : lo + N // 6] = 1
        elif kind == 1:
            mk[i % 22 :: 22] = 1
        else:
            mk = (torch.rand(N, generator=gcpu) < 0.3).to(torch.int8)
        stack.append(mk)
    gm_all = torch.stack(stack).to(dev)
    forms = [(name, {"mask": mk.to(dev)}) for name, mk in one_masks.items()]
    for G in (8, 32):
        ids = torch.randint(0, G, (B,), generator=gcpu, dtype=torch.int32).to(dev)
        forms.append((f"gmask_G{G}", {"gmasks": gm_all[:G].contiguous(), "mask_ids": ids}))
    for n_valid in (N, N - 1000):
        for m in (1, 4):
            for name, kw in forms:
                key = "mips_g_scan_gmask" if "gmasks" in kw else "mips_g_scan_mask"
                ok, err, shape = check_b1(key, n_valid, m, q8, qs, gscale, codes, RB, **kw)
                emit("b1m", form=name, n_valid=n_valid, merge_tiles=m, shape=shape,
                     bit_equal=ok, max_abs_err=err)
                if not ok:
                    raise AssertionError(f"B1 {name} form disagrees with its plain version "
                                         f"(n_valid={n_valid}, M={m})")
    del codes, gm_all, forms

    # ---- 4. B2 vs plain ----
    H, HK, DH = 16, 8, 128
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
        err_of["qknorm_rope_attention"] = max(err_of["qknorm_rope_attention"], err)
        emit("b2", S=S, B=BB, cosine=cosv, max_abs_err=err, max_abs_plain=ref)
        if not (cosv > 0.9999 and err <= 2e-2 * ref):
            raise AssertionError(f"B2 kernel disagrees with its plain version at S={S}")

    # ---- 4b. B3 and B4 vs plain on one full-width int8 layer ----
    cfg = EncoderConfig()
    lcfg = EncoderConfig(num_layers=1)
    layer = init_params(lcfg, torch.Generator(device=dev).manual_seed(2), device=dev)["layers"][0]
    lq = kernel_layout(quantize_params_int8({"layers": [layer]}))[0]
    texts = slogans(4096)
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    slog_len = torch.tensor([min(len(tok.tokenize(t_)) + 2, 64) for t_ in texts[:512]], device=dev)
    mask512 = (torch.arange(64, device=dev)[None] < slog_len[:, None]).to(torch.int32)

    def rand_x(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def check_b3b4(kind, x, mask=None):
        """One kernel vs its plain version: the output and the block's own
        contribution (out - x) at cosine > 0.9999 and max abs <=
        2e-2 * max|plain|, and the norm + quant codes bit-equal."""
        stages = {}
        if kind == "attn":
            rope = _rope_tables(torch.clamp(mask.cumsum(1) - 1, min=0), DH, lcfg.rope_theta)
            out = fused_attn_int8_layer(x, layer, lq, mask, rope, lcfg, stages=stages)
            ref = fused_attn_int8_layer_plain(x, layer, lq, mask, rope, lcfg)
            norm_w, name = layer["attn_norm"], "fused_attn_int8_layer"
        else:
            args = (x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
            out = fused_mlp_int8_layer(*args, eps=lcfg.rms_norm_eps, stages=stages)
            ref = fused_mlp_int8_layer_plain(*args, eps=lcfg.rms_norm_eps)
            norm_w, name = layer["mlp_norm"], "fused_mlp_int8_layer"
        xq, sx = rmsnorm_quant_plain(x.reshape(-1, x.shape[-1]), norm_w, lcfg.rms_norm_eps)
        torch.cuda.synchronize()
        codes_equal = torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
        cosv, err, ref_max = agreement(out, ref)
        dcos, derr, dmax = agreement(out.float() - x.float(), ref.float() - x.float())
        err_of[name] = max(err_of[name], err)
        shape = list(x.shape)
        emit("b3b4", kernel=name, shape=shape, cosine=cosv, max_abs_err=err, max_abs_plain=ref_max,
             block_cosine=dcos, block_max_abs_err=derr, block_max_abs_plain=dmax,
             codes_bit_equal=codes_equal)
        if not (cosv > 0.9999 and err <= 2e-2 * ref_max and dcos > 0.9999
                and derr <= 2e-2 * dmax and codes_equal):
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")

    x512 = rand_x(512, 64, cfg.hidden_size)
    check_b3b4("attn", x512, mask512)
    for S in (32, 128):
        lens = torch.randint(1, S + 1, (64,), generator=g, device=dev)
        check_b3b4("attn", rand_x(64, S, cfg.hidden_size),
                   (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32))
    for shape in ((512, 64), (64, 32), (64, 128), (70 * 128 + 70,)):
        check_b3b4("mlp", rand_x(*shape, cfg.hidden_size))

    # ---- 4c. B6 vs plain: raw scores of a batch against probed chunks ----
    for bb, p6, r6 in ((8, 526, 256), (16, 526, 256), (64, 1500, 256), (13, 5, 128), (8, 3, 512)):
        g6 = torch.Generator(device=dev).manual_seed(bb * 10_000 + p6)
        c6, fills = p6 + 8, max(1, p6 // 10)
        sl6 = torch.randint(-127, 128, (c6, r6, D), generator=g6, device=dev, dtype=torch.int8)
        sl6[-1] = 0                                   # the empty fill chunk
        real6 = torch.randperm(c6 - 1, generator=g6, device=dev)[: p6 - fills]
        u6 = torch.cat([torch.sort(real6).values,
                        torch.full((fills,), c6 - 1, device=dev)]).to(torch.int32)
        q6 = torch.randn((bb, D), generator=g6, device=dev)
        ck, qk6 = ivf_probe_scores(q6, sl6, u6)
        cp, qp6 = ivf_probe_scores_plain(q6, sl6, u6)
        torch.cuda.synchronize()
        err = int((ck.long() - cp.long()).abs().max())
        err_of["ivf_probe_scores"] = max(err_of["ivf_probe_scores"], err)
        ok = torch.equal(ck, cp) and torch.equal(qk6, qp6)
        emit("b6", shape=[bb, p6, r6, D], fills=fills, bit_equal=ok, max_abs_err=err)
        if not ok:
            raise AssertionError(f"B6 kernel disagrees with its plain version at {[bb, p6, r6, D]}")
    del sl6, ck, cp

    # ---- 5. encoder at full width ----
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    n_params = params["embed"].numel() + sum(
        t_.numel() for layer_ in params["layers"] for t_ in layer_.values())
    encoder = BatchedEncoder(params, cfg, batch_size=512, device=dev)
    encoder8 = BatchedEncoder(params, cfg, batch_size=512, device=dev, quant="int8")
    ql = encoder8.qlayers
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
        # int8 (w8a8): every layer on B3 and B4, and through their plain versions
        p8k = encode_pooled(params, t[0], t[1], cfg, qlayers=ql, fused_layers=True)
        p8p = encode_pooled(params, t[0], t[1], cfg, fused="plain", qlayers=ql, fused_layers=True)
        p8h = encode_pooled(params, t[0][:256], t[1][:256], cfg, fused="plain", qlayers=ql,
                            fused_layers=True)
    # the text -> ids path runs from here to the end of phase 7; the
    # comparison launches above are not counted
    path_start()
    t0 = time.perf_counter()
    slogan_emb = encoder.encode(texts)
    enc_s = time.perf_counter() - t0
    int8_before = (attn_int8_launches.n, mlp_int8_launches.n)
    t0 = time.perf_counter()
    slogan_emb8 = encoder8.encode(texts)
    enc8_s = time.perf_counter() - t0
    int8_enc_launches = (attn_int8_launches.n - int8_before[0], mlp_int8_launches.n - int8_before[1])
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
    cos8 = float((p8k.double() * p8p.double()).sum(1).min())
    floor8 = float((p8h.double() * p8p[:256].double()).sum(1).min())
    vs_bf16 = float((p8k.double() * pk.double()).sum(1).min())
    slogan_self = float(np.min(np.sum(slogan_emb8 * slogan_emb, axis=1)))
    emit("encoder_int8", encode_4096_s=round(enc8_s, 3),
         cos_kernel_vs_plain_min=cos8, cos_plain_b256_vs_plain_b512_min=floor8,
         cos_int8_vs_bf16_kernel_min=vs_bf16, cos_slogans_int8_vs_bf16_min=slogan_self,
         finite=bool(np.isfinite(slogan_emb8).all()),
         launches={"fused_attn_int8_layer": int8_enc_launches[0],
                   "fused_mlp_int8_layer": int8_enc_launches[1]})
    if not (cos8 > 0.999 and vs_bf16 > 0.98 and min(int8_enc_launches) >= cfg.num_layers
            and np.isfinite(slogan_emb8).all() and slogan_emb8.shape == (4096, cfg.embedding_dim)):
        raise AssertionError("encoder_int8 phase failed")

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
    meta = bench_metadata(NC, texts, CorpusMetadata)
    engine = SearchEngine(index, meta=meta, rescore_vectors=corpus, device=dev)
    # the fp32 oracle's corpus, on the card once rather than per call
    corpus_dev = torch.from_numpy(corpus).to(dev)
    qd = [unit_rows(1024, D, 1000 + s, dev) for s in range(5)]
    _, oracle = exact_topk(torch.cat(qd), corpus_dev, k=10, device=dev)
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
    def serve_round(service_, bodies, threads=64):
        server = SearchServer(service_, "127.0.0.1", 0).start()
        url = f"http://127.0.0.1:{server.port}/search"

        def post(body):
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        try:
            with ThreadPoolExecutor(threads) as ex:
                # one warm round first: each new batch size's first pass
                # pays one-time set-up (pinned host blocks, GEMM choice)
                list(ex.map(post, bodies))
                service_.scheduler.reset_traces()
                warm = service_.scheduler.stats()
                t0_ = time.perf_counter()
                answers_ = list(ex.map(post, bodies))
                wall = time.perf_counter() - t0_
            st = service_.scheduler.stats()
        finally:
            server.stop()
            service_.scheduler.shutdown()
        return answers_, wall, st, warm

    sched = BatchScheduler(engine, max_batch=256, encode_fn=encoder.encode_device)
    service = SearchService(engine, encoder.encode, scheduler=sched)
    direct = SearchService(engine, encoder.encode)
    qtexts = [texts[(37 * i) % 4096] for i in range(128)]
    answers, serve_s, stats, warm = serve_round(service, [{"query": t_, "top_k": 10} for t_ in qtexts])
    n_batches = stats["batches"] - warm["batches"]
    n_queries = stats["queries"] - warm["queries"]
    path1 = path_end()
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
         launches=path1)
    if not (codes_ok and joined and np.mean(overlaps) >= 0.9 and len(answers) >= 64):
        raise AssertionError("serve phase failed")
    if path1["mips_g_scan"] < 1 or path1["qknorm_rope_attention"] < 1:
        raise AssertionError(f"a kernel of the text -> ids path never launched: {path1}")

    # ---- 7b. serving with the int8 encoder ----
    sched8 = BatchScheduler(engine, max_batch=256, encode_fn=encoder8.encode_device)
    service8 = SearchService(engine, encoder8.encode, scheduler=sched8)
    direct8 = SearchService(engine, encoder8.encode)
    path_start()
    answers8, serve8_s, stats8, warm8 = serve_round(service8, [{"query": t_, "top_k": 10} for t_ in qtexts])
    path5 = path_end()
    codes8 = all(code == 200 for code, _ in answers8)
    joined8 = all(
        len(body["results"]) == 10 and all("theorem_slogan" in r and "paper_url" in r for r in body["results"])
        for _, body in answers8)
    overlaps8, self_hits8 = [], 0
    for text, (_, body) in zip(qtexts, answers8):
        got = [r["doc_id"] for r in body["results"]]
        want = [r["doc_id"] for r in direct8.search_and_display(text)]
        overlaps8.append(len(set(got) & set(want)) / 10)
        self_hits8 += texts.index(text) == got[0]
    nb8 = stats8["batches"] - warm8["batches"]
    emit("serve_int8", requests=len(answers8), all_200=codes8, metadata_joined=joined8,
         overlap10_mean=float(np.mean(overlaps8)), overlap10_min=float(np.min(overlaps8)),
         self_top1=self_hits8, wall_s=round(serve8_s, 3), batches=nb8,
         avg_batch=(stats8["queries"] - warm8["queries"]) / max(nb8, 1),
         latency_ms=stats8.get("latency_ms"), stages_ms={
             k: v for k, v in stats8.get("stages_ms", {}).items() if k != "worst_batches"},
         launches=path5)
    if not (codes8 and joined8 and np.mean(overlaps8) >= 0.9 and len(answers8) == 128):
        raise AssertionError("serve_int8 phase failed")
    if path5["fused_attn_int8_layer"] < 1 or path5["fused_mlp_int8_layer"] < 1:
        raise AssertionError(f"B3 or B4 never launched on the int8 serving path: {path5}")

    # ---- 8b. B1's three forms on the engine's own 1M index ----
    n_valid, rb = engine.n_valid, engine.row_block
    m = auto_merge_tiles(D, rb // 128, engine.padded_rows // rb)
    f3 = [_filters_from_ui(dict(f)) for f in MIX3]
    f36 = [_filters_from_ui(dict(f)) for f in MIX36]
    t0 = time.perf_counter()
    host_masks = [engine._combined_mask_inputs(f)[0] for f in f3 + f36]   # cached per signature
    mask_build_s = time.perf_counter() - t0
    year_dev = engine._combined_mask_inputs(f3[0])[1]
    st36 = torch.stack([engine._combined_mask_inputs(f)[1] for f in f36])
    gids = torch.randint(0, 36, (1024,), generator=gcpu, dtype=torch.int32).to(dev)
    q8, qs = quantize_queries(qd[0])
    for name, key, kw in (("none", "mips_g_scan", {}), ("year_mask", "mips_g_scan_mask", {"mask": year_dev}),
                          ("gmask_36", "mips_g_scan_gmask", {"gmasks": st36, "mask_ids": gids})):
        ok, err, shape = check_b1(key, n_valid, m, q8, qs, engine._global_scale, engine.vectors, rb, **kw)
        emit("b1m", form=name, n_valid=n_valid, merge_tiles=m, shape=shape, bit_equal=ok,
             max_abs_err=err, index="1M")
        if not ok:
            raise AssertionError(f"B1 {name} form disagrees with its plain version on the 1M index")

    # ---- 9. filtered search on the speed path ----
    qf = unit_rows(512, D, 2000, dev)
    path_start()
    rec, passed, routes_of = {}, True, {}
    for j, (f, mk) in enumerate(zip(f3 + f36, host_masks)):
        r0 = dict(engine.route_counts)
        _, ids = engine.search_vectors(qf, k=10, filters=f)
        routes_of[j] = sorted(r for r, c in engine.route_counts.items() if c > r0.get(r, 0))
        _, orc = exact_topk(qf, corpus_dev, k=10, device=dev, mask=mk)
        rec[j] = recall_vs_exact(ids, orc, k=10)
        passed &= bool(mk[ids[ids >= 0]].all()) and bool((ids >= 0).all())
    # a mixed batch of the 36 signatures: grouped scans (split 32 + 4)
    sig_of = np.random.default_rng(9).integers(0, 36, 512)
    r0 = dict(engine.route_counts)
    _, gids_out = engine.search_vectors(qf, k=10, filters=[f36[s_] for s_ in sig_of])
    grouped_runs = engine.route_counts.get("grouped", 0) - r0.get("grouped", 0)
    path2 = path_end()
    mismatch = 0
    for s_ in range(36):
        rows = np.nonzero(sig_of == s_)[0]
        if rows.size:
            _, ip = engine.search_vectors(qf[torch.from_numpy(rows).to(dev)], k=10, filters=f36[s_])
            mismatch += int((ip != gids_out[rows]).any(axis=1).sum())
    emit("filtered", batch=512, signatures=len(rec), recall_min=min(rec.values()),
         recall_mix3=[rec[j] for j in range(3)], recall_mix36_min=min(rec[j] for j in range(3, 39)),
         all_pass_filter=passed, broad_filter_route=routes_of[2], year_route=routes_of[0],
         routes=dict(engine.route_counts), grouped_scans=grouped_runs,
         grouped_vs_per_signature_rows_differing=mismatch, mask_builds=engine.filter_mask_builds,
         mask_build_s=round(mask_build_s, 3), launches=path2)
    if not (min(rec.values()) >= 0.99 and passed and "overfetch" in routes_of[2]
            and routes_of[0] == ["masked"] and grouped_runs == 2 and mismatch == 0
            and path2["mips_g_scan_mask"] >= 1 and path2["mips_g_scan_gmask"] >= 1):
        raise AssertionError("filtered phase failed")

    # ---- 10. B5 vs plain ----
    t0 = time.perf_counter()
    xindex = FlatIndex.build(corpus, config=IndexConfig(dtype="int8"), device=dev)   # per-row scales
    rescore_bf16 = torch.from_numpy(corpus).to(torch.bfloat16)                       # host copy
    xeng = SearchEngine(xindex, meta=meta, rescore_vectors=rescore_bf16, device=dev)
    xbuild_s = time.perf_counter() - t0
    bias = torch.where(torch.rand(NC, generator=gcpu) < 0.4, float("-inf"), 0.0).to(dev)
    xb = unit_rows(262_144, D, 11, dev)
    corpora = {"int8_perrow_1M": (xeng.vectors, xeng.scales, bias, True),
               "bf16_262k": (xb.to(torch.bfloat16), None, bias[:262_144].contiguous(), False),
               "f32_262k": (xb, None, bias[:262_144].contiguous(), False)}
    del xb
    cases = [(bb, k_, wb) for bb in (8, 512) for k_ in (10, 40, 400) for wb in (False, True)]
    for cname, (cc, sc, bi, exact) in corpora.items():
        qb5 = unit_rows(512, D, 12, dev)
        qk = quantize_queries(qb5)[0] if cc.dtype == torch.int8 else qb5.to(cc.dtype).contiguous()
        for bb, k_, wb in (cases if cname != "f32_262k" else [(512, 10, True), (8, 40, False)]):
            nv = cc.shape[0] - (1000 if wb else 0)
            sk, ik = mips_topk(qk[:bb], cc, sc, nv, bi if wb else None, k_)
            sp, ip = mips_topk_plain(qk[:bb], cc, sc, nv, bi if wb else None, k_)
            torch.cuda.synchronize()
            ok, err = topk_agree(sk, ik, sp, ip, exact)
            err_of["mips_topk"] = max(err_of["mips_topk"], err)
            emit("b5", corpus=cname, batch=bb, k=k_, bias=wb, n_valid=nv, agree=ok, max_abs_err=err)
            if not ok:
                raise AssertionError(f"B5 kernel disagrees with its plain version ({cname}, B={bb}, k={k_})")
    del corpora

    # ---- 11. the exact route: per-row int8 index, bf16 host rescore ----
    year = f3[0]
    xq = [unit_rows(512, D, 3000 + s, dev) for s in range(5)]
    path_start()
    xres = [(xeng.search_vectors(qq, k=10)[1], xeng.search_vectors(qq, k=10, filters=year)[1]) for qq in xq]
    path3 = path_end()
    year_mask = host_masks[0]
    xrec, xrec_f, xpass = [], [], True
    for qq, (ids_u, ids_f) in zip(xq, xres):
        xrec.append(recall_vs_exact(ids_u, exact_topk(qq, corpus_dev, k=10, device=dev)[1], k=10))
        xrec_f.append(recall_vs_exact(ids_f, exact_topk(qq, corpus_dev, k=10, device=dev,
                                                        mask=year_mask)[1], k=10))
        xpass &= bool(year_mask[ids_f[ids_f >= 0]].all())
    emit("exact", rows=NC, speed_ok=xeng._speed_ok, build_s=round(xbuild_s, 3),
         recall_draws=xrec, recall_min=min(xrec), recall_year_draws=xrec_f,
         recall_year_min=min(xrec_f), all_pass_filter=xpass, routes=dict(xeng.route_counts),
         launches=path3)
    if not (not xeng._speed_ok and min(xrec) >= 0.99 and min(xrec_f) >= 0.99 and xpass
            and path3["mips_topk"] >= 10):
        raise AssertionError("exact phase failed")

    # ---- 12. filtered serving over HTTP ----
    fsched = BatchScheduler(engine, max_batch=256, encode_fn=encoder.encode_device)
    fservice = SearchService(engine, encoder.encode, scheduler=fsched)
    pick = np.random.default_rng(13).integers(0, 36, 256)
    ftexts = [texts[(53 * i) % 4096] for i in range(256)]
    bodies = [{"query": t_, "top_k": 10, "filters": MIX36[p_]} for t_, p_ in zip(ftexts, pick)]
    path_start()
    fanswers, fserve_s, fstats, fwarm = serve_round(fservice, bodies)
    path4 = path_end()
    fcodes = all(code == 200 for code, _ in fanswers)
    fpass = all(
        host_masks[3 + p_][[r["doc_id"] for r in body["results"]]].all()
        for p_, (_, body) in zip(pick, fanswers))
    fover = []
    for t_, p_, (_, body) in zip(ftexts, pick, fanswers):
        got = {r["doc_id"] for r in body["results"]}
        want = {r["doc_id"] for r in direct.search_and_display(t_, f36[p_])}
        fover.append(len(got & want) / max(len(want), 1))
    fb = fstats["batches"] - fwarm["batches"]
    emit("serve_filtered", requests=len(fanswers), all_200=fcodes, all_pass_filter=fpass,
         overlap10_mean=float(np.mean(fover)), overlap10_min=float(np.min(fover)),
         wall_s=round(fserve_s, 3), batches=fb,
         avg_batch=(fstats["queries"] - fwarm["queries"]) / max(fb, 1),
         filtered_batches=fstats.get("filtered_batches"), g_mean=fstats.get("filtered_g_mean"),
         latency_ms=fstats.get("latency_ms"), stages_ms={
             k: v for k, v in fstats.get("stages_ms", {}).items() if k != "worst_batches"},
         launches=path4)
    if not (fcodes and fpass and np.mean(fover) >= 0.9 and fstats.get("filtered_g_mean", 0) > 1
            and path4["mips_g_scan_gmask"] >= 1):
        raise AssertionError("serve_filtered phase failed")

    # ---- 14. IVF build on a 1M x 1024 clustered corpus ----
    NI, NL = 1_048_576, 4096
    t0 = time.perf_counter()
    gi = torch.Generator(device=dev).manual_seed(21)
    centres = torch.randn((NL, D), generator=gi, device=dev)
    centres /= centres.norm(dim=1, keepdim=True)
    member = torch.randint(0, NL, (NI,), generator=gi, device=dev)
    ivf_corpus = np.empty((NI, D), np.float32)
    for i in range(0, NI, 131_072):
        xc = centres[member[i : i + 131_072]] + (1.5 / np.sqrt(D)) * torch.randn(
            (131_072, D), generator=gi, device=dev)
        ivf_corpus[i : i + 131_072] = (xc / xc.norm(dim=1, keepdim=True)).cpu().numpy()
    ivf_corpus[:4096] = slogan_emb
    del member, xc
    gen_s = time.perf_counter() - t0
    stage_s = {}

    def stage(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] = time.perf_counter() - t_
            return out
        return run

    real_stages = (ivf_mod.train_kmeans, ivf_mod._assign_top2)
    ivf_mod.train_kmeans = stage("kmeans_s", real_stages[0])
    ivf_mod._assign_top2 = stage("assign_s", real_stages[1])
    try:
        t0 = time.perf_counter()
        ivf = IVFIndex.build(ivf_corpus, config=IndexConfig(ivf_nlist=NL, dtype="int8"),
                             slab_rows=args.ivf_slab_rows, device=dev)
        ivf_build_s = time.perf_counter() - t0
    finally:
        ivf_mod.train_kmeans, ivf_mod._assign_top2 = real_stages
    t0 = time.perf_counter()
    pa = ivf._device_arrays()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    ids_all = torch.cat([ivf.slab_ids.reshape(-1), ivf.spill_ids])
    ids_all = ids_all[ids_all >= 0]
    n_spill = int((ivf.spill_ids >= 0).sum())
    # where each row landed: its best list (0), another list's slack
    # (relocated overflow, 1) or the spill (2)
    R_ivf = int(ivf.slabs.shape[1])
    home = np.full(NI, 2, np.int8)
    cents_dev = pa["cents"]
    with torch.inference_mode():
        best_list = torch.cat([(torch.from_numpy(ivf_corpus[i : i + 131_072]).to(dev) @ cents_dev.T)
                               .argmax(1) for i in range(0, NI, 131_072)]).cpu().numpy()
    sid = ivf.slab_ids.numpy()
    lists_of = np.repeat(np.arange(NL), R_ivf).reshape(NL, R_ivf)
    live = sid >= 0
    home[sid[live]] = (best_list[sid[live]] != lists_of[live]).astype(np.int8)
    emit("ivf_build", rows=NI, dim=D, nlist=NL, slab_rows=int(ivf.slabs.shape[1]),
         corpus_gen_s=round(gen_s, 3), build_s=round(ivf_build_s, 3),
         kmeans_s=round(stage_s["kmeans_s"], 3), assign_s=round(stage_s["assign_s"], 3),
         pack_quant_normalize_s=round(ivf_build_s - stage_s["kmeans_s"] - stage_s["assign_s"], 3),
         upload_s=round(upload_s, 3), spill_rows=n_spill, spill_chunks=pa["n_spill_chunks"],
         relocated_rows=int((home == 1).sum()),
         memory_bytes=ivf.memory_bytes(), global_scale=ivf.global_scale)
    if not (ivf.probe_major_ok and ids_all.numel() == NI and int(torch.unique(ids_all).numel()) == NI):
        raise AssertionError("ivf_build phase failed")
    del ids_all

    # ---- 15. calibrated nprobe, recall at B=8, latency ----
    ivf_dev = torch.from_numpy(ivf_corpus).to(dev)
    ivf_dev /= ivf_dev.norm(dim=1, keepdim=True)        # the rows the index packed
    draws = []
    for s_ in range(5):
        gq_ = torch.Generator(device=dev).manual_seed(500 + s_)
        qq = centres[torch.randint(0, NL, (128,), generator=gq_, device=dev)] + (
            1.5 / np.sqrt(D)) * torch.randn((128, D), generator=gq_, device=dev)
        qq /= qq.norm(dim=1, keepdim=True)
        draws.append((qq, exact_topk(qq, ivf_dev, k=10, device=dev)[1]))

    def ivf_recall(nprobe_):
        fn_ = ivf.device_searcher(k=10, nprobe=nprobe_)
        recs_, ids_ = [], []
        for qq, orc in draws:
            got = torch.cat([fn_(qq[j : j + 8])[1] for j in range(0, 128, 8)]).cpu().numpy()
            ids_.append(got)
            recs_.append(recall_vs_exact(got, orc, k=10))
        return recs_, ids_

    path_start()
    t0 = time.perf_counter()
    np_cal, rec_cal = calibrate_nprobe(ivf, ivf_dev, gate=0.99)
    cal_s = time.perf_counter() - t0
    ivf.config = ivf.config.replace(ivf_nprobe=int(np_cal), ivf_nprobe_calibrated=rec_cal >= 0.99)
    sweep, cal_ids = {}, None
    for npb in sorted({16, 32, 64, int(np_cal)}):
        sweep[npb], ids_k = ivf_recall(npb)
        if npb == np_cal:
            cal_ids = ids_k
    path6 = path_end()
    # the true neighbours the calibrated search missed, by where they live
    missed = np.concatenate([orc[~(orc[:, :, None] == got[:, None, :]).any(2)]
                             for (_, orc), got in zip(draws, cal_ids)])
    missed_by_home = {h: int((home[missed] == i).sum()) for i, h in enumerate(("best_list", "relocated", "spill"))}
    ivf_mod.ivf_probe_scores = ivf_probe_scores_plain
    try:
        _, plain_ids = ivf_recall(int(np_cal))
    finally:
        ivf_mod.ivf_probe_scores = ivf_probe_scores
    plain_equal = all(np.array_equal(a, b) for a, b in zip(cal_ids, plain_ids))
    fn_cal = ivf.device_searcher(k=10, nprobe=int(np_cal))
    q8b, q16b = draws[0][0][:8].contiguous(), draws[0][0][:16].contiguous()
    flat_ivf = FlatIndex.build(ivf_corpus, config=IndexConfig(dtype="int8", int8_scale="global"),
                               device=dev)
    eng_ivf = SearchEngine(flat_ivf, meta=meta, rescore_vectors=ivf_corpus, device=dev, ivf_index=ivf)
    lat = {"ivf_b8": cuda_ms(lambda: fn_cal(q8b), 30, warmup=3),
           "ivf_b16": cuda_ms(lambda: fn_cal(q16b), 30, warmup=3),
           "flat_b8": cuda_ms(lambda: eng_ivf._speed_search(q8b, 10, 10), 30, warmup=3),
           "flat_b16": cuda_ms(lambda: eng_ivf._speed_search(q16b, 10, 10), 30, warmup=3)}
    flat_rec = [recall_vs_exact(torch.cat([eng_ivf._speed_search(qq[j : j + 8], 10, 10)[1]
                                           for j in range(0, 128, 8)]).cpu().numpy(), orc, k=10)
                for qq, orc in draws]
    emit("ivf", calibrated_nprobe=int(np_cal), calibration_recall=rec_cal, calibrate_s=round(cal_s, 3),
         recall_b8_min={str(k_): min(v) for k_, v in sweep.items()},
         recall_b8_draws={str(k_): v for k_, v in sweep.items()},
         flat_recall_b8_min=min(flat_rec), plain_b6_ids_equal=plain_equal,
         missed_neighbours=missed_by_home,
         latency_ms=lat, gpu=gpu, launches=path6)
    if not (min(sweep[int(np_cal)]) >= 0.99 and plain_equal and path6["ivf_probe_scores"] >= 1):
        raise AssertionError("ivf phase failed")

    # ---- 16. IVF serving over HTTP ----
    isched = BatchScheduler(eng_ivf, max_batch=16, encode_fn=encoder.encode_device)
    iservice = SearchService(eng_ivf, encoder.encode, scheduler=isched)
    idirect = SearchService(eng_ivf, encoder.encode)
    itexts = [texts[(29 * i) % 4096] for i in range(128)]
    eng_ivf.warm_overfetch(batch_sizes=(1, 8, 16), k=10)
    r0 = dict(eng_ivf.route_counts)
    path_start()
    ianswers, iserve_s, istats, iwarm = serve_round(
        iservice, [{"query": t_, "top_k": 10} for t_ in itexts], threads=8)
    path7 = path_end()
    ivf_batches = eng_ivf.route_counts.get("ivf", 0) - r0.get("ivf", 0)
    icodes = all(code == 200 for code, _ in ianswers)
    ijoined = all(
        len(body["results"]) == 10 and all("theorem_slogan" in r and "paper_url" in r for r in body["results"])
        for _, body in ianswers)
    iover, iself = [], 0
    for text, (_, body) in zip(itexts, ianswers):
        got = [r["doc_id"] for r in body["results"]]
        want = [r["doc_id"] for r in idirect.search_and_display(text)]
        iover.append(len(set(got) & set(want)) / 10)
        iself += texts.index(text) == got[0]
    ib = istats["batches"] - iwarm["batches"]
    emit("serve_ivf", requests=len(ianswers), all_200=icodes, metadata_joined=ijoined,
         ivf_route_batches=ivf_batches, routes=dict(eng_ivf.route_counts),
         overlap10_mean=float(np.mean(iover)), overlap10_min=float(np.min(iover)), self_top1=iself,
         wall_s=round(iserve_s, 3), batches=ib, avg_batch=(istats["queries"] - iwarm["queries"]) / max(ib, 1),
         latency_ms=istats.get("latency_ms"), stages_ms={
             k: v for k, v in istats.get("stages_ms", {}).items() if k != "worst_batches"},
         launches=path7)
    if not (icodes and ijoined and ivf_batches > 0 and np.mean(iover) >= 0.9 and len(ianswers) == 128
            and path7["ivf_probe_scores"] >= 1):
        raise AssertionError("serve_ivf phase failed")

    # ---- 13. times at the path's shapes (not counted as main-path
    # launches) ----
    qb = qd[0]
    q8, qs = quantize_queries(qb)
    nrows = engine.padded_rows
    out_bytes = 1024 * (nrows // (rb * m)) * 128 * 4
    times = {}

    def timed(name, kernel, plain, nbytes, ops, plain_iters=3):
        times[name] = {"ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, plain_iters),
                       **bound(nbytes, ops), "library_ms": None}

    timed("mips_g_scan", lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m),
          lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m),
          nrows * D + 1024 * D + out_bytes, {"int8": 2 * 1024 * n_valid * D})
    # masked forms: only the passing rows' products and codes are needed
    n_year = int(host_masks[0].sum())
    timed("mips_g_scan_mask", lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m, mask=year_dev),
          lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m, mask=year_dev),
          nrows + n_year * D + 1024 * D + out_bytes, {"int8": 2 * 1024 * n_year * D})
    st32, g32 = st36[:32].contiguous(), torch.randint(0, 32, (1024,), generator=gcpu, dtype=torch.int32)
    pass_of = np.array([int(mk.sum()) for mk in host_masks[3:35]])
    n_union = int(np.logical_or.reduce(host_masks[3:35]).sum())
    g32 = g32.to(dev)
    timed("mips_g_scan_gmask",
          lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m, gmasks=st32, mask_ids=g32),
          lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m, gmasks=st32, mask_ids=g32),
          32 * nrows + n_union * D + 1024 * (D + 4) + out_bytes,
          {"int8": 2 * int(pass_of[g32.cpu().numpy()].sum()) * D})
    qx = quantize_queries(unit_rows(512, D, 14, dev))[0]
    timed("mips_topk", lambda: mips_topk(qx, xeng.vectors, xeng.scales, NC, None, 40),
          lambda: mips_topk_plain(qx, xeng.vectors, xeng.scales, NC, None, 40),
          NC * (D + 4) + 512 * D + 512 * 40 * 8, {"int8": 2 * 512 * NC * D}, plain_iters=2)
    qbf = unit_rows(512, D, 15, dev).to(torch.bfloat16)
    bf_corpus = engine._rescore_device
    timed("mips_topk_bf16", lambda: mips_topk(qbf, bf_corpus, None, NC, None, 40),
          lambda: mips_topk_plain(qbf, bf_corpus, None, NC, None, 40),
          NC * D * 2 + 512 * D * 2 + 512 * 40 * 8, {"bf16": 2 * 512 * NC * D}, plain_iters=2)

    def pipeline(scan):
        def run():
            a8, sc = quantize_queries(qb)
            cand = scan(a8, engine.vectors, n_valid, rb, m)
            _, li = select_candidates(cand, sc, engine._global_scale, 40, rb, m)
            return device_rescore(qb, li, engine._rescore_device, n_valid, k=10)
        return run

    pipe_k = cuda_ms(pipeline(mips_g_scan), 10)
    pipe_p = cuda_ms(pipeline(mips_g_scan_plain), 3)
    with torch.inference_mode():
        enc_k = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, fused="on"), 5)
        enc_p = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, fused="plain"), 5)
        enc8_k = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, qlayers=ql, fused_layers=True), 5)
        enc8_p = cuda_ms(lambda: encode_pooled(params, t[0], t[1], cfg, fused="plain", qlayers=ql,
                                               fused_layers=True), 2)
    S = int(t.shape[2])
    qa = torch.randn((512, S, H * DH), generator=g, device=dev).to(torch.bfloat16)
    ka = torch.randn((512, S, HK * DH), generator=g, device=dev).to(torch.bfloat16)
    va = torch.randn((512, S, HK * DH), generator=g, device=dev).to(torch.bfloat16)
    cos = torch.randn((512, S, DH // 2), generator=g, device=dev)
    sin = torch.randn((512, S, DH // 2), generator=g, device=dev)
    msk = t[1].to(torch.int32).contiguous()
    wq = torch.ones(DH, device=dev)
    kwargs = dict(num_heads=H, num_kv_heads=HK, head_dim=DH, eps=1e-6, causal=True)
    live = msk.sum(1).double()
    # causal pairs of live tokens, QK^T and PV at 2 operations a product
    att_ops = float(4 * H * DH * (live * (live + 1) / 2).sum())
    att_bytes = (qa.numel() * 2 + ka.numel() * 2 * 2 + qa.numel() * 2
                 + cos.numel() * 4 * 2 + msk.numel() * 4 + DH * 4 * 2)
    timed("qknorm_rope_attention",
          lambda: fused_qknorm_rope_attention(qa, ka, va, wq, wq, cos, sin, msk, **kwargs),
          lambda: fused_qknorm_rope_attention_plain(
              qa, ka, va, wq, wq, cos, sin, msk, scale=1.0 / np.sqrt(DH), **kwargs),
          att_bytes, {"bf16": att_ops}, plain_iters=5)
    # B3 and B4 at (512, 64) on the phase-4b layer: x read and the output
    # written once, the int8 weights and scales read once
    T, DM, HQ, HKD, I = x512.shape[0] * x512.shape[1], cfg.hidden_size, H * DH, HK * DH, cfg.intermediate_size
    rope512 = _rope_tables(torch.clamp(mask512.cumsum(1) - 1, min=0), DH, cfg.rope_theta)
    live512 = mask512.sum(1).double()
    att512_ops = float(4 * H * DH * (live512 * (live512 + 1) / 2).sum())
    timed("fused_attn_int8_layer",
          lambda: fused_attn_int8_layer(x512, layer, lq, mask512, rope512, lcfg),
          lambda: fused_attn_int8_layer_plain(x512, layer, lq, mask512, rope512, lcfg),
          2 * T * DM * 2 + 2 * DM * (HQ + HKD) + 4 * (HQ + 2 * HKD + DM) + T * (DH * 4 + 4),
          {"int8": 2 * T * DM * (2 * HQ + 2 * HKD), "bf16": att512_ops})
    timed("fused_mlp_int8_layer",
          lambda: fused_mlp_int8_layer(x512, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"]),
          lambda: fused_mlp_int8_layer_plain(x512, layer["mlp_norm"], lq["w_gate"], lq["w_up"],
                                             lq["w_down"]),
          2 * T * DM * 2 + 3 * DM * I + 4 * (2 * I + 2 * DM), {"int8": 6 * T * DM * I})
    # B6 at the ivf phase's B=8 search: the unique chunks read once, the
    # queries read and the raw scores written once
    captured = {}

    def capture(q_, s_, u_):
        captured.update(q=q_, s=s_, u=u_)
        return ivf_probe_scores(q_, s_, u_)

    ivf_mod.ivf_probe_scores = capture
    try:
        fn_cal(q8b)
    finally:
        ivf_mod.ivf_probe_scores = ivf_probe_scores
    cq, cs, cu = captured["q"], captured["s"], captured["u"]
    P6, R6 = cu.shape[0], cs.shape[1]
    distinct6 = int(torch.unique(cu).numel())
    n_spill_ch = pa["n_spill_chunks"]

    def b6_device_ms(q_, s_, u_, n=20):
        """The kernel's own device time (profiler), per launch: at B=8 the
        wrapper's query quantization (~9 small torch ops) is host-bound
        and would hide it from CUDA events around whole calls."""
        ivf_probe_scores(q_, s_, u_)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof6:
            for _ in range(n):
                ivf_probe_scores(q_, s_, u_)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof6.key_averages() if "ivf_scores_kernel" in e.key)
        if us <= 0:
            raise AssertionError("the profiler saw no device time of the B6 kernel")
        return us / n / 1e3

    def b6_bytes_ops(b_, p_, r_, distinct_):
        return (distinct_ * r_ * D + b_ * D * 4 + 4 * b_ * p_ * r_ + 4 * b_,
                {"int8": 2 * b_ * p_ * r_ * D})

    timed("ivf_probe_scores", lambda: ivf_probe_scores(cq, cs, cu),
          lambda: ivf_probe_scores_plain(cq, cs, cu), *b6_bytes_ops(8, P6, R6, distinct6), plain_iters=10)
    b6_wrapper_ms = times["ivf_probe_scores"]["ms"]
    times["ivf_probe_scores"]["ms"] = b6_device_ms(cq, cs, cu)
    # B6 at the b6 phase's shapes (random slabs, every chunk distinct but
    # the fills): the kernel's device time against its bound
    b6_shapes = {}
    for bb, p6, r6 in ((8, 526, 256), (16, 526, 256), (64, 1500, 256)):
        g6 = torch.Generator(device=dev).manual_seed(bb * 10_000 + p6)
        sl6 = torch.randint(-127, 128, (p6 + 8, r6, D), generator=g6, device=dev, dtype=torch.int8)
        fills = max(1, p6 // 10)
        u6 = torch.cat([torch.arange(p6 - fills, device=dev),
                        torch.full((fills,), p6 + 7, device=dev)]).to(torch.int32)
        q6 = torch.randn((bb, D), generator=g6, device=dev)
        nb, ops6 = b6_bytes_ops(bb, p6, r6, p6 - fills + 1)
        b6_shapes[f"{bb}x{p6}x{r6}"] = {"device_ms": b6_device_ms(q6, sl6, u6), **bound(nb, ops6)}
    del sl6
    emit("times", gpu=gpu, kernels=times,
         shapes={"mips_g_scan*": [1024, NC, D, rb, m], "mips_topk": [512, NC, D, 40],
                 "qknorm_rope_attention": [512, S, H, HK, DH],
                 "fused_*_int8_layer": [*x512.shape[:2], DM, I, H, HK, DH],
                 "ivf_probe_scores": {"B": 8, "P": P6, "R": R6, "D": D, "distinct_chunks": distinct6,
                                      "spill_chunks": n_spill_ch, "nprobe": int(np_cal)}},
         ivf_search_ms=lat, ivf_probe_scores_wrapper_ms=b6_wrapper_ms, b6_shapes=b6_shapes,
         scan_rescore_ms_per_batch={"kernel": pipe_k, "plain": pipe_p, "qps_kernel": 1024 / pipe_k * 1e3},
         encoder_forward_ms={"kernel": enc_k, "plain": enc_p, "shape": [512, S]},
         encoder_int8_forward_ms={"kernel": enc8_k, "plain": enc8_p, "shape": [512, S]},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         total_s=round(time.perf_counter() - t_start, 1))

    # a filtered batch of at most 32 signatures: ONE grouped scan
    grouped_batch = [f36[s_] for s_ in sig_of if s_ < 32]
    qg = qf[: len(grouped_batch)]
    for name, fn in (
        ("encoder_forward_512x64", lambda: encode_pooled(params, t[0], t[1], cfg)),
        ("encoder_int8_forward_512x64",
         lambda: encode_pooled(params, t[0], t[1], cfg, qlayers=ql, fused_layers=True)),
        ("scan_rescore_b1024", pipeline(mips_g_scan)),
        (f"filtered_grouped_b{len(grouped_batch)}",
         lambda: engine.search_vectors(qg, k=10, filters=grouped_batch)),
        (f"ivf_search_b8_nprobe{int(np_cal)}", lambda: fn_cal(q8b)),
    ):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
        emit("profile", what=name, gpu=gpu, top_device_us=[
            [e.key[:60], round(e.self_device_time_total, 1), e.count] for e in rows])

    sources = {
        "mips_g_scan": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_g_scan_mask": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_g_scan_gmask": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_topk": ("theoremsearch_tpu_torch/csrc/mips_topk.cu", "theoremsearch_tpu/kernels/mips.py:75"),
        "qknorm_rope_attention": ("theoremsearch_tpu_torch/csrc/attention.cu",
                                  "theoremsearch_tpu/kernels/attention.py:60"),
        "fused_attn_int8_layer": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                  "theoremsearch_tpu/kernels/layer_int8.py:274"),
        "fused_mlp_int8_layer": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                 "theoremsearch_tpu/kernels/layer_int8.py:151"),
        "ivf_probe_scores": ("theoremsearch_tpu_torch/csrc/ivf_scores.cu",
                             "theoremsearch_tpu/kernels/mips.py:789"),
    }
    missing = [n for n, c in main_launches.items() if c < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    print(gpu)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name], "max_abs_err": err_of[name], **times[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
