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
             (B, S) = (512, 64), ragged masks; and the heads a shard of
             the tensor-parallel phases: 4/2 at (512, 64) (mesh_encode_tp)
             and 8/4 at (32, 64) (mesh_train's data rows).
 4g. b2g     B2's gemma form vs plain: H=3/1, Dh=256, bidirectional, scale
             256^-1/2, S in {32, 64, 128} at B=64 and (512, 64), ragged masks.
 4b. b3b4    the whole-layer int8 kernels B4 (MLP block) and B3
             (attention block) vs their plain versions on one full-width
             layer of random weights quantized by quantize_params_int8:
             (B, S) = (512, 64) with the slogans' ragged masks, (64, 32),
             (64, 128), and an MLP input of 70 * 128 + 70 rows; the norm +
             quant stage's int8 codes bit-equal.
 4h. b3b4g   B3 and B4's gemma forms (post-norms with (1 + w) weights, GeGLU,
             the bidirectional head_dim-256 core) vs plain on one full-width
             GemmaEncoderConfig() layer (norm weights off zero), at the
             phase-4b shapes; the norm + quant codes bit-equal.
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
             and 262,144 x 1024 bf16 / f32 corpora, B 8, 64 and 512, k
             10, 40, 400, with no bias, a random 0/-inf bias and the year
             filter's (a contiguous 30% of the ids passing); a second
             launch bit-equal to the first.
11. exact    SearchEngine on the 1M per-row int8 index with a bf16 host
             rescore copy (kernel B5), unfiltered and year-filtered, min
             recall@10 over 5 draws of 512, and the route's wall time a
             batch.
11r. residual  a 1,048,576 x 1024 residual capacity index (2 bytes/dim:
             FlatIndex.build(config.residual) on the card) on the speed
             path with the device residual rescore: min recall@10 over
             phase 6's 5 draws of 1024, batch ms beside phase 6's bf16-copy
             engine; then the reference's 6,291,456-row capacity rung
             (bench.py), built chunk by chunk on the card: recall over 2
             draws of 1024 (oracle over the regenerated chunks), batch ms.
11l. live    a second engine over phase 6's index (bf16 copy) at B=512:
             baseline batch ms; 10,240 adds (each at rank 1); 1,000 main
             and 100 delta deletes (no deleted id returned, the tombstone
             over-fetch's batch ms); year-filtered and 36-signature grouped
             batches over tombstones and the delta (every id passes, mask
             build ms); phase 11's per-row index with the deletes (B5's
             bias form); min recall@10 >= 0.99 over the live rows after
             each step; B1's three forms and B5's bias form at these inputs
             bit-equal to plain.
11c. compact compact() then compact(reclaim=True), each while a client
             thread queries (seconds, longest query, queries during); the
             folded codes bit-equal to a fresh FlatIndex.build of the same
             rows; a batch dispatched before the reclaim swap returns new
             ids; recall held after both.
11s. serve_live  POST /documents with 32 new slogans (B2 encodes them),
             /search finds each by its text, /documents/delete, then the
             deleted ids are absent; all 200.
12. serve_filtered  256 POST /search with filters from the 36-signature
             mix, 64 client threads, after a warm round: all 200, every
             result passes its filter, overlap@10 vs the direct path,
             grouped scans carrying more than one signature.
13. times    kernel / plain / bound times at the main path's shapes (B1
             unmasked, mask and gmask G=32 at B=1024 on 1M, with their
             device times (launches queued behind a sleep kernel) beside;
             the unmasked form also at B=8 and 64, first held bit-equal to
             plain there (the mask and gmask forms too at B=8), and its
             int8 product alone through torch._int_mm in 16,384-row slices
             (library_ms); B5 at B=512, k=40
             on 1M int8 per-row and bf16, beside torch._int_mm /
             torch.matmul over the same products in 16,384-row slices
             (library_ms), and on int8 at B=8 and 64 (bit-equal to plain
             there first), with the year bias (and its computed-group
             share) and at k=400, as device time and back to back; B2, B3
             and B4 at (512, 64); B6
             at the ivf phase's B=8 search and the b6 shapes, as device
             time: its launches queued behind a sleep kernel, between
             CUDA events), B2 in both forms at (64, 64) too, B3 and B4's
             int8 products alone (i8_gemm_kernel's device time in a
             profile) beside torch._int_mm on the same shapes (the
             kernels line's library_ms; the port never calls it), the bf16
             and int8 encoder
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
16l. ivf_live  phase 15's index behind a second engine: 1,024 adds, 1,024
             deletes, compact and reclaim (IVFIndex.with_updates and
             remap_ids): recall@10 at B=8 >= 0.99 at the calibrated nprobe
             after each step, the IVF route kept, B6 bit-equal to plain on
             the updated slabs.
16m. mesh_search / mesh_live / mesh_ivf / mesh_serve  the serving paths
             row-sharded over four shards on the card (make_mesh(
             MeshConfig(shard=4), devices=[cuda:0] * 4); each shard's
             kernels run on its slice, the per-shard top-k lists are merged
             on the first device), held to the single-device engines:
             mesh_search: phase 6's index, min recall@10 over the 5 draws
             of 1,024, overlap@10 with the single-device engine >= 0.99 and
             scores within 5e-3, the year mask and the 36-signature grouped
             mix (every id passes, recall >= 0.99 per signature), the exact
             route (B5 a shard) at B=512, k=40 (ids equal where scores are
             unique, unfiltered and year-filtered), the residual index
             sharded (recall >= 0.99), mesh vs single batch ms at B=1024;
             mesh_live: 10,240 adds, 1,100 deletes, an update, compact and
             reclaim (each while a client queries) on a meshed and a
             single-device engine over phase 6's index, after each step
             recall >= 0.99 over the live rows, no deleted id, and no row
             where the mesh finds fewer true neighbours than the single
             device (the share of equal ids reported); mesh_ivf: phase
             15's index behind a meshed engine at the calibrated nprobe,
             recall@10 at B=8 >= 0.99, held to the single-device searcher
             the same way; mesh_serve: scheduler + HTTP over the meshed
             engine with the int8 encoder data-parallel on
             [cuda:0] * 2, 128 requests (overlap@10 >= 0.9 vs the
             single-device service; pooled cosine of the dp encode vs the
             one-device encode >= 0.999 int8, >= 0.9999 bf16). B1, B5 and
             B6 must run once a shard a batch in each window. On more than
             one card mesh_search also runs over the distinct cards.
16t. mesh_encode_tp  tensor-parallel encoding at full width (`shard_params`
             + BatchedEncoder(mesh=)): qwen bf16 with vocab 151,936 (the
             Qwen3 family's padded vocabulary: the reference's vocab
             sharding refuses the odd 151,669) on (1, 4) over [cuda:0] * 4,
             head-local at 4/2 heads a shard; gemma (3/1 heads, gathered on
             the first device) and BERT-base (no kernel) on (1, 2); 4,096
             slogans each against the single-device encoder: pooled cosine
             >= 0.999; the same tower in f32 throughout on 512 slogans at
             a pooled row distance <= 1e-4 from one device (f32 rounding:
             the same function); int8 on the tp mesh refused ("dp-only"), B2 4 a
             layer a batch (qwen), B2's gemma form once a layer a batch;
             tp and one-device encode seconds.
20. encoder_gemma / encoder_gemma_int8  the embeddinggemma-300m-class
             tower at full width (GemmaEncoderConfig(): 24 layers, d 768,
             3/1 heads of 256, vocab 262,144, the 768 -> 3072 -> 768 head;
             random bf16 weights from a seeded generator, norm weights off
             zero): kernel vs plain pooled cosine (> 0.9999 bf16, > 0.999
             int8 on B3/B4's gemma forms), int8 vs bf16, 4,096 slogans
             through BatchedEncoder in each mode.
21. serve_gemma  a 1,048,576 x 768 int8-global FlatIndex with its bf16
             copy (random unit rows, the first 4,096 the gemma slogan
             embeddings); B1 at D = 768 bit-equal to plain once; then
             SearchService + scheduler + HTTP with the gemma encoder, 128
             POST /search, overlap@10 vs the direct path, in bf16 and int8.
22. bert     BertEncoderConfig() (12 x 768, no kernel): 4,096 slogans
             through BatchedEncoder, forward ms at (512, 64), pooled cosine
             of the card vs a CPU run of the same weights on 8 items.
17. b7       the fused attention backward kernel vs its plain version,
             H=16/8, Dh=128, (B, S) = (64, 32), (64, 64), (64, 128) with
             ragged masks (mask[:, 0] = 1, g zero on padded rows) and the
             training shape (64, 64) with full masks, and mesh_train's
             8/4 heads a shard at a data row's (32, 64) with full masks; a
             second launch bit-equal to the first. (The 1M engines are
             freed first.)
18. train    contrastive fine-tuning at full width (EncoderConfig(
             max_seq_len=64), 64 pairs x 64 tokens, lr 2e-5, temperature
             0.05, tools/train_bench.py's synthetic task from numpy seed 0):
             one batch's gradients "on" vs "plain" (and vs "off") per leaf
             of layers 0 and 27, embed and final_norm; 20 steps "on"
             (B2 forward, B7 backward: step_ms, tokens/s, model TFLOP/s,
             peak memory) and the same 20 steps "off" from the same
             weights (max |d loss|); 5 LoRA steps (rank 8, wq/wv) with the
             base bit-unchanged; B2 and B7 launched 56 times a step.
18g. train_gemma  GemmaEncoderConfig(max_seq_len=64) at full width, 64
             pairs x 64 tokens of the same task: one batch's gradients "on"
             vs "plain" per leaf of layers 0 and 23, embed and final_norm
             (cosine >= 0.999, a nonzero gradient on wq through the fused
             core), 8 steps "on" (loss finite and falling, step ms, peak
             memory, B2's gemma form 48 launches a step).
18m. mesh_train  the dp + tp train step at full width on a (data=2,
             shard=2) mesh over [cuda:0] * 4 (dryrun_multichip(4)'s mesh),
             fused "on": the qwen tower with vocab 151,936, 64 pairs x 64
             tokens of phase 18's batches (32 if 64 runs out of memory);
             weights from one generator in a single-device state and,
             through shard_train_state, in the sharded one: one batch's loss
             within 2e-2 and every logical leaf's gradient at cosine >=
             0.999 against the single device; 6 steps, each loss finite and
             within 2e-2 of the single-device trajectory; B2 and B7 224
             times a step each (2 data rows x 2 shards x (q, p) x 28
             layers, head-local at 8/4 heads); step ms and tokens/s beside
             the single device's, peak memory. It runs here, after the
             engines are freed, for the memory the 64 x 64 step needs.
19. train_cli  `python -m theoremsearch_tpu_torch train` on the card over
             data/validation_set.csv: 10 steps with --eval and checkpoints
             every 5, then --steps 20 on the same directory (resumed at
             step 10). Its hermetic encoder has head_dim 32, so this phase
             runs the reference's composition and no B7: phase 18 carries
             the kernel.
23. catalog_cli  the catalog -> encoder -> index -> engine -> HTTP path
             through the port's CLI, at full width: a Qwen3 checkpoint of
             EncoderConfig() (random bf16 weights from a seeded generator,
             HF layout, written as .safetensors by this script, with a
             WordLevel tokenizer.json over slogans()'s words) loaded
             through --model-dir and held bit-equal to what was written;
             a sqlite catalog of 100,000 theorems (20,000 papers of 5, one
             slogan each, bench_metadata's layout); `embed` into an
             int8-global-residual spool (B2 28 times a forward), a second
             `embed` embedding 0; `search` on the speed route (B1) with min
             recall@10 >= 0.99 over 5 draws of 1,024 vs the fp32 oracle
             and 64 metadata rows equal to the catalog's join;
             make_search_server(--quant int8 --warm --refresh-interval
             0.5): 128 POST /search from 64 threads (overlap@10 >= 0.9; the
             served requests alone launch B1, B3 and B4), then 1,024 new
             theorems and 256 new latest slogans written from a second
             connection are live within 60 s, found
             at rank 1, the superseded docs gone; a restart through
             build_engine_from_catalog (101,024 rows, the latest slogans
             only, the speed route, the recall gate); `build-ivf
             --calibrate` (B6, nprobe holding 0.99); `train --model-dir
             --catalog` (4 steps of 64 x 64, B2 and B7 56 times a step, a
             checkpoint); `eval` and `compare-embedders` on the checkpoint.
24. multiproc_gloo / multiproc_nccl  the run across processes
             (core/distributed.py), each process a
             tests/torch_multihost_worker.py on this card, after the
             parent empties its cache. multiproc_gloo: two processes over
             Gloo (NCCL refuses two ranks on one card), both on cuda:0, two
             mesh entries each: the 1M x 1024 speed path at B=1024 over
             4 shards (2 a process) and the exact route (B5) at B=512, each
             bit-equal across the processes and to a one-process
             [cuda:0] * 4 engine, min recall@10 over 5 draws >= 0.99, B1
             and B5 2 a batch a process; 10,240 adds, an update, 1,100
             deletes and compact(reclaim=True), identical across the
             processes; the list-sharded IVF searcher (B6) at B=8 on a
             262,144 x 1024 clustered corpus built once by process 0,
             equal to the one-process searcher; an int8 dp encode of 4,096
             slogans (qwen, B3/B4) at cosine >= 0.9999 to one device;
             mesh_train's step on (data 2, shard 2), one data row a
             process, 3 steps: losses identical across the processes and
             within 1e-3 (first) / 5e-3 (all) of mesh_train's, params
             bit-identical, B2 and B7 112 a step a process; against the
             one-process (2, 2) mesh process 0 runs itself, the first
             loss equal and the losses, gradient norms and final params
             within MP_TRAIN_LIMITS; the staged bf16 Gloo sum bit-equal
             to the f32 sum of the gathered tensors; step ms, the Gloo
             all-reduce's ms by stage and staged bytes, peak memory.
             multiproc_nccl: one process over NCCL (world 1) on four
             entries: the speed search and one train step bit-equal to the
             one-process mesh, and a speed batch under
             utils/profiling.trace whose Chrome trace names B1's kernel.
24t. multiproc_tp  tensor parallelism across processes (ROADMAP A.12),
             Gloo, one mesh entry a process on cuda:0: (a) (1, 2) over two
             processes, the full-width qwen tower head-local: the tp
             encode of 512 slogans (cosine >= 0.9999 to the one-process
             [cuda:0] * 2 mesh, >= 0.999 to one device, identical across
             the processes), gemma's gathered encode of 64, mesh_train's
             batch for 3 steps (identical losses and params across the
             processes, within MP_TRAIN_LIMITS of the one-process (1, 2)
             mesh, B2 and B7 56 a step a process), a checkpoint restored
             on one device bit-equal; (b) (2, 2) over four processes, qwen
             at 4 layers, 2 steps (B2/B7 8 a step a process) and a B=1024
             speed batch on 262,144 x 1024, bit-equal across the
             processes and to the one-process (2, 2) engine. The
             collectives by op a step, step and encode seconds, peak
             memory (`multiproc_tp`).
13. times    (emitted last) the kernel / plain / bound times above, B7 and
             B2 at the training shape (64, 64, 16, 8, 128), the train step
             "on" and "off", and the script's total seconds.

Each path (phases 5-7, 7b, 9, 11, 11r, 11l, 11c, 11s, 12, 15, 16, 16l,
16m, 16t, 18, 18m, 18g, 20, 21, 23) runs with every launch counter set to 0 just before it
and read just after; kernel-vs-plain comparisons run
outside those windows, so the `launches` in the kernels line count only
launches made by the main paths (BatchedEncoder, SearchEngine, the HTTP
stack, the train step). Inside phase 23's window its checks (the recall
draws, the direct path the served answers are held to) are counted apart
and taken out.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line per phase; `at_s` is the script's elapsed seconds."""
    print(json.dumps({"phase": phase, **kw, "at_s": round(time.perf_counter() - _T0, 1)}), flush=True)


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


def queued_ms(fn, iters: int) -> float:
    """Device time per call: the calls are queued behind a sleep kernel,
    so the host has enqueued them all before the card starts, and timed
    between two CUDA events. A wrapper whose host work (many small torch
    ops) outlasts its device work on a busy host would otherwise be timed
    by the host."""
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


def write_safetensors(path, tensors: dict) -> None:
    """`tensors` (name -> CPU tensor, bf16 or f32) as a .safetensors file:
    an 8-byte little-endian header length, the JSON header, then each
    tensor's raw little-endian bytes (the card's machine has no
    safetensors package)."""
    import torch

    tags = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)


def qwen_checkpoint(cfg, dev, seed: int) -> tuple[dict, dict]:
    """(config.json dict with Qwen3's field names, HF-layout tensors) of
    `cfg` with random bf16 weights from a seeded generator on `dev`:
    linear weights N(0, 0.02^2) as (out, in), norm weights 1 + N(0, 0.1^2)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, scale, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16).cpu()

    h, dh = cfg.hidden_size, cfg.head_dim
    t = {"model.embed_tokens.weight": rand((cfg.vocab_size, h), 0.02),
         "model.norm.weight": rand((h,), 0.1, 1.0)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t |= {p + "input_layernorm.weight": rand((h,), 0.1, 1.0),
              p + "self_attn.q_proj.weight": rand((cfg.num_heads * dh, h), 0.02),
              p + "self_attn.k_proj.weight": rand((cfg.num_kv_heads * dh, h), 0.02),
              p + "self_attn.v_proj.weight": rand((cfg.num_kv_heads * dh, h), 0.02),
              p + "self_attn.o_proj.weight": rand((h, cfg.num_heads * dh), 0.02),
              p + "self_attn.q_norm.weight": rand((dh,), 0.1, 1.0),
              p + "self_attn.k_norm.weight": rand((dh,), 0.1, 1.0),
              p + "post_attention_layernorm.weight": rand((h,), 0.1, 1.0),
              p + "mlp.gate_proj.weight": rand((cfg.intermediate_size, h), 0.02),
              p + "mlp.up_proj.weight": rand((cfg.intermediate_size, h), 0.02),
              p + "mlp.down_proj.weight": rand((h, cfg.intermediate_size), 0.02)}
    config = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
              "vocab_size": cfg.vocab_size, "hidden_size": h,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
              "head_dim": dh, "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
              "max_position_embeddings": 32768, "tie_word_embeddings": True,
              "torch_dtype": "bfloat16"}
    return config, t


def word_level_tokenizer(path: str, words: list[str]) -> None:
    """Writes a HuggingFace tokenizer into the checkpoint dir `path`: a
    WordLevel model over `words` (lowercased, split at whitespace and
    punctuation; a word not in `words` is <unk>) with an end-of-text
    token appended, as Qwen3's template appends one, and its
    tokenizer_config.json."""
    vocab = {"<pad>": 0, "<unk>": 1, "<eot>": 2} | {w: i + 3 for i, w in enumerate(words)}
    special = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True} for c, i in list(vocab.items())[:3]]
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump({
            "version": "1.0", "truncation": None, "padding": None, "added_tokens": special,
            "normalizer": {"type": "Lowercase"},
            "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                          {"SpecialToken": {"id": "<eot>", "type_id": 0}}],
                               "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                                        {"Sequence": {"id": "B", "type_id": 0}}],
                               "special_tokens": {"<eot>": {"id": "<eot>", "ids": [2],
                                                            "tokens": ["<eot>"]}}},
            "decoder": None,
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "unk_token": "<unk>", "model_max_length": 32768}, f)


def fill_catalog(cat, papers_: range, per_paper: int, texts: list[str], first: int = 0) -> None:
    """Papers `papers_` with `per_paper` theorems each and one slogan per
    theorem: the k-th new theorem has slogan texts[k] and theorem and
    slogan id first + k + 1. The metadata is bench_metadata's layout:
    years in contiguous blocks of 1/30 of the 100,000-theorem corpus,
    striped categories, journal status alternating, citations p % 1000."""
    block = 100_000 // 30
    papers, theorems, slogan_rows = [], [], []
    for pi, p in enumerate(papers_):
        i0 = first + pi * per_paper
        papers.append({
            "paper_id": f"2401.{p:05d}", "title": f"Paper {p}", "authors": [f"Author {p % 97}"],
            "summary": "", "link": f"https://arxiv.org/abs/2401.{p:05d}",
            "last_updated": f"{1995 + min(i0 // block, 29)}-06-01",
            "journal_ref": "J. Math." if p % 2 else None, "primary_category": CATS[p % len(CATS)],
            "categories": [CATS[p % len(CATS)]], "citations": p % 1000})
        for j in range(per_paper):
            i = i0 + j
            theorems.append({"theorem_id": i + 1, "paper_id": f"2401.{p:05d}",
                             "name": f"Theorem {j + 1}", "body": f"$x_{{{i}}}$ is bounded.",
                             "label": None, "parsing_method": "synthetic"})
            slogan_rows.append({"slogan_id": i + 1, "theorem_id": i + 1, "model": "offline-stub",
                                "prompt_id": "body-only-v1",
                                "slogan": texts[i - first]})
    cat.upsert_rows("paper", papers, ["paper_id"])
    cat.upsert_rows("theorem", theorems, ["theorem_id"])
    cat.upsert_rows("theorem_slogan", slogan_rows, ["slogan_id"])


def spool_corpus(spool: str, dev, keep=None):
    """(sorted slogan ids, their L2-normalized f32 rows on `dev`) of a
    spool, restricted to the ids in `keep` when given: the fp32 oracle's
    corpus in the rebuilt engine's row order."""
    import torch

    from theoremsearch_tpu_torch.index.builder import IndexBuilder

    ids, emb = map(np.concatenate, zip(*IndexBuilder(spool).batches()))
    if keep is not None:
        m = np.isin(ids, np.fromiter(keep, np.int64))
        ids, emb = ids[m], emb[m]
    order = np.argsort(ids, kind="stable")
    x = torch.from_numpy(emb[order]).to(dev)
    return ids[order], x / x.norm(dim=1, keepdim=True)


def min_recall(engine, corpus_dev, dev, draws: int = 5, nq: int = 1024) -> list[float]:
    """recall@10 of `engine` over `draws` draws of `nq` random unit query
    vectors against the fp32 oracle (TF32 off) over `corpus_dev`."""
    import torch

    from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
    from theoremsearch_tpu_torch.eval.oracle import exact_topk

    qd = [unit_rows(nq, corpus_dev.shape[1], 5000 + s, dev) for s in range(draws)]
    _, oracle = exact_topk(torch.cat(qd), corpus_dev, k=10, device=dev)
    out = []
    for s in range(draws):
        _, ids = engine.search_vectors(qd[s], k=10)
        out.append(recall_vs_exact(np.asarray(ids), oracle[s * nq : (s + 1) * nq], k=10))
    return out


def catalog_cli(dev, gpu: str, counters: dict, cfg=None, n_papers: int = 20_000,
                per_paper: int = 5, n_new: int = 1024, n_regen: int = 256,
                train_steps: int = 4) -> dict:
    """Phase catalog_cli: the catalog -> encoder -> index -> engine -> HTTP
    path through the port's CLI at full width (see the module docstring).
    Returns the phase's numbers; raises if a gate fails. Launch gates are
    checked last, after every other check. The kernels the phase's own
    checks launch (the recall draws, the direct searches the served
    answers are compared with) are counted apart, under
    "check_launches", for the caller to take out of the window."""
    import argparse
    import contextlib
    import gc
    import shutil
    import tempfile

    import torch

    from theoremsearch_tpu_torch.cli import _batched_encoder, build_parser, run as cli_run
    from theoremsearch_tpu_torch.cli import make_search_server
    from theoremsearch_tpu_torch.core.config import EncoderConfig
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.loader import _QWEN_MAPPING
    from theoremsearch_tpu_torch.index.builder import IndexBuilder
    from theoremsearch_tpu_torch.ingest import Catalog
    from theoremsearch_tpu_torch.pipeline import build_engine_from_catalog
    from theoremsearch_tpu_torch.serve.app import SearchService

    cfg = cfg or EncoderConfig()
    work = tempfile.mkdtemp(prefix="chip_smoke_catalog_")
    model_dir, db = os.path.join(work, "qwen"), os.path.join(work, "catalog.db")
    spool, ivf_out, ck_dir = (os.path.join(work, d) for d in ("spool", "ivf", "ckpt"))
    n = n_papers * per_paper

    def snap() -> dict:
        return {k: c.n for k, c in counters.items()}

    def delta(a: dict, b: dict) -> dict:
        return {k: b[k] - a[k] for k in a if b[k] != a[k]}

    check = dict.fromkeys(counters, 0)

    @contextlib.contextmanager
    def aside():
        """Counts the launches of a check's own work into `check`."""
        a = snap()
        try:
            yield
        finally:
            for k, v in delta(a, snap()).items():
                check[k] += v

    launch_faults: list = []
    out: dict = {"gpu": gpu, "check_launches": check}
    try:
        # 1. the checkpoint, written and loaded through the CLI's --model-dir
        t0 = time.perf_counter()
        config, tensors = qwen_checkpoint(cfg, dev, seed=11)
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(config, f)
        write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
        write_s = time.perf_counter() - t0
        # its tokenizer: one token for each word slogans() writes and, as
        # the hermetic tokenizer has, one for each number (up to the
        # vocabulary's size: every rank); with digits one token each, the
        # random model embedded slogans of one word pattern all but alike
        words = sorted({w for t_ in slogans(16_384) for w in re.findall("[a-z]+", t_.lower())})
        word_level_tokenizer(model_dir, words + [str(i) for i in
                                                 range(cfg.vocab_size - 3 - len(words))])
        t0 = time.perf_counter()
        be = _batched_encoder(argparse.Namespace(model_dir=model_dir, device=dev))
        load_s = time.perf_counter() - t0
        bad = []
        for name, t in tensors.items():
            name = name[len("model."):]
            if name in ("embed_tokens.weight", "norm.weight"):
                got = be.params["embed" if name.startswith("embed") else "final_norm"]
            else:
                li, sub = name[len("layers."):].split(".", 1)
                key, tr, _ = _QWEN_MAPPING[sub]
                got = be.params["layers"][int(li)][key]
                t = t.T if tr else t
            if not torch.equal(got.cpu(), t.to(got.dtype)):
                bad.append(name)
        ck_bytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        del tensors
        out["checkpoint"] = {"bytes": ck_bytes, "write_s": write_s, "load_s": load_s,
                             "tensors_not_bit_equal": bad[:8], "config_is_EncoderConfig": be.cfg == cfg,
                             "tokenizer": type(be.tokenizer).__name__}
        emit("catalog_cli", step="checkpoint", **out["checkpoint"], gpu=gpu)
        if bad or be.cfg != cfg or type(be.tokenizer).__name__ != "HFTokenizer":
            raise AssertionError(f"checkpoint load: {out['checkpoint']}")

        # 2. the catalog: n theorems on n_papers papers, one slogan each,
        # dealt through a seeded permutation: slogans() repeats its word
        # pattern every 256 texts, which in generator order puts
        # near-duplicates in one lane cell of B1's packed maxima, where
        # both packages lose the same recall (the CPU twin
        # tests/test_torch_pipeline.py::test_lane_cell_near_duplicates).
        # The texts that arrive while serving follow.
        order = np.concatenate([np.random.default_rng(17).permutation(n),
                                np.arange(n, n + n_new + n_regen)])
        generated = slogans(n + n_new + n_regen)
        texts = [generated[j] for j in order]
        t0 = time.perf_counter()
        cat = Catalog(db)
        fill_catalog(cat, range(n_papers), per_paper, texts[:n])
        fill_s = time.perf_counter() - t0
        out["catalog"] = {"papers": n_papers, "theorems": cat.count("theorem"),
                          "slogans": cat.count("theorem_slogan"), "fill_s": fill_s}
        emit("catalog_cli", step="catalog", **out["catalog"], gpu=gpu)

        # 3. embed, bf16, into an int8-global-residual spool
        c0 = snap()
        t0 = time.perf_counter()
        n_emb = cli_run(["--catalog", db, "embed", "--model-dir", model_dir, "--spool", spool,
                         "--index-dtype", "int8-global-residual"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        c1 = snap()
        again = cli_run(["--catalog", db, "embed", "--model-dir", model_dir, "--spool", spool])
        manifest = cat.count("embedding_manifest")
        # pages of 256 (embed_missing_slogans), forwards of <= 64 (BatchedEncoder)
        n_fwd = sum(-(-min(256, n - s) // 64) for s in range(0, n, 256))
        out["embed"] = {"slogans": n_emb, "seconds": embed_s, "slogans_per_s": n_emb / embed_s,
                        "second_embed": again, "manifest_rows": manifest, "forwards": n_fwd,
                        "launches": delta(c0, c1)}
        emit("catalog_cli", step="embed", **out["embed"], gpu=gpu)
        if not (n_emb == n and again == 0 and manifest == n):
            raise AssertionError(f"embed: {n_emb} embedded, then {again}; manifest {manifest}")
        if c1["qknorm_rope_attention"] - c0["qknorm_rope_attention"] != cfg.num_layers * n_fwd:
            launch_faults.append(f"embed: B2 launched {delta(c0, c1)}, want "
                                 f"{cfg.num_layers} x {n_fwd} forwards")

        # 4. search: one query through the subcommand, then the recall gate
        c0 = snap()
        t0 = time.perf_counter()
        engine = cli_run(["--catalog", db, "search", texts[12345 % n], "--model-dir", model_dir,
                          "--spool", spool])
        search_s = time.perf_counter() - t0
        c1 = snap()
        routes = dict(engine.route_counts)
        sids, corpus = spool_corpus(spool, dev)
        with aside():
            recalls = min_recall(engine, corpus, dev)
        spread = corpus[:: n // 256][:256]
        pair_cos = (spread @ spread.T)[torch.triu_indices(256, 256, 1, device=dev).unbind()]
        rng = np.random.default_rng(3)
        sample = rng.choice(engine.n_valid, 64, replace=False)
        meta_bad = []
        for d in sample.tolist():
            r = cat.conn.execute(
                "SELECT p.paper_id, t.name, s.slogan, p.primary_category, p.citations,"
                " p.journal_ref, p.last_updated FROM theorem_slogan s"
                " JOIN theorem t ON t.theorem_id = s.theorem_id"
                " JOIN paper p ON p.paper_id = t.paper_id WHERE s.slogan_id = ?",
                (int(sids[d]),)).fetchone()
            m = engine.meta
            got = (m.paper_id[d], m.theorem_name[d], m.slogan[d], m.primary_category[d],
                   int(m.citations[d]), m.journal_ref[d], int(m.year[d]))
            if got != (r[0], r[1], r[2], r[3], r[4], r[5], int(r[6][:4])):
                meta_bad.append(d)
        out["search"] = {"seconds": search_s, "route_counts": routes,
                         "rows": engine.n_valid, "recall_draws": recalls,
                         "recall_min": min(recalls), "slogan_mean_pairwise_cos": float(pair_cos.mean()),
                         "meta_rows_checked": 64,
                         "meta_rows_wrong": meta_bad, "launches": delta(c0, c1)}
        emit("catalog_cli", step="search", **out["search"], gpu=gpu)
        if not (routes == {"speed": 1} and engine.n_valid == n
                and min(recalls) >= 0.99 and not meta_bad):
            raise AssertionError(f"search: {out['search']}")
        if c1["mips_g_scan"] - c0["mips_g_scan"] < 1:
            launch_faults.append(f"search: B1 never launched {delta(c0, c1)}")
        del engine, corpus

        # 5. serve: int8 encoder, warm, refresh thread; then catalog writes
        args = build_parser().parse_args(
            ["--catalog", db, "serve", "--model-dir", model_dir, "--spool", spool, "--quant", "int8",
             "--warm", "--refresh-interval", "0.5", "--max-batch", "256", "--host", "127.0.0.1",
             "--port", "0", "--feedback-path", ""])
        c0 = snap()
        t0 = time.perf_counter()
        srv, sched = make_search_server(args)
        start_s = time.perf_counter() - t0
        srv.start()
        live = sched.engine
        c_warm = snap()
        base = f"http://127.0.0.1:{srv.port}"

        def post(body):
            req = urllib.request.Request(base + "/search", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t_ = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read()), time.perf_counter() - t_

        def corpus_size():
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                return json.loads(r.read())["corpus"]

        try:
            qtexts = [texts[(37 * i) % n] for i in range(128)]
            with ThreadPoolExecutor(64) as ex:
                list(ex.map(post, [{"query": t_, "top_k": 10} for t_ in qtexts]))
                answers = list(ex.map(post, [{"query": t_, "top_k": 10} for t_ in qtexts]))
            c_served = snap()
            lat = np.array([a[2] for a in answers]) * 1e3
            overlaps = []
            with aside():       # the direct path the served answers are held to
                be8 = BatchedEncoder(be.params, be.cfg, tokenizer=be.tokenizer,
                                     prompts=be.prompts, quant="int8", device=dev)
                direct = SearchService(live, be8.for_role("query"))
                for text, (_, body, _) in zip(qtexts, answers):
                    got = {r["doc_id"] for r in body["results"]}
                    want = {r["doc_id"] for r in direct.search_and_display(text)}
                    overlaps.append(len(got & want) / 10)
            # a second connection writes: n_new theorems on new papers, and
            # n_regen existing theorems get a new latest slogan
            writer = Catalog(db)
            t_write = time.perf_counter()
            fill_catalog(writer, range(n_papers, n_papers + n_new // 4), 4, texts[n : n + n_new],
                         first=n)
            regen_tids = [1 + (i * (n // n_regen)) for i in range(n_regen)]
            writer.upsert_rows("theorem_slogan", [
                {"theorem_id": tid, "model": "offline-stub", "prompt_id": "body-and-abstract-v1",
                 "slogan": texts[n + n_new + j]} for j, tid in enumerate(regen_tids)],
                ["theorem_id", "model", "prompt_id"])
            writer.close()
            deadline = t_write + 60
            while time.perf_counter() < deadline and not (
                    len(live.meta) == n + n_new + n_regen and corpus_size() == n + n_new):
                time.sleep(0.1)
            refresh_s = time.perf_counter() - t_write
            num_live = corpus_size()
            new_q = [(texts[n + i], f"2401.{n_papers + i // 4:05d}", f"Theorem {i % 4 + 1}", None)
                     for i in range(n_new)]
            regen_q = [(texts[n + n_new + j], f"2401.{(tid - 1) // per_paper:05d}",
                        f"Theorem {(tid - 1) % per_paper + 1}", tid - 1)
                       for j, tid in enumerate(regen_tids)]
            with ThreadPoolExecutor(64) as ex:
                found = list(ex.map(post, [{"query": q[0], "top_k": 10} for q in new_q + regen_q]))
            rank1 = stale_seen = 0
            for (_, pid, name, old), (code, body, _) in zip(new_q + regen_q, found):
                top = body["results"][0] if code == 200 and body["results"] else {}
                rank1 += top.get("paper_id") == pid and top.get("theorem_name") == name
                stale_seen += old is not None and old in {r["doc_id"] for r in body["results"]}
        finally:
            srv.stop()
            sched.shutdown()
        c1 = snap()
        poller_alive = any(t_.name == "catalog-refresh" for t_ in threading.enumerate())
        out["serve"] = {
            "start_s": start_s, "requests": len(answers),
            "all_200": all(a[0] == 200 for a in answers),
            "latency_ms": {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99))},
            "overlap10_mean": float(np.mean(overlaps)), "overlap10_min": float(np.min(overlaps)),
            "refresh_s": refresh_s, "num_live": num_live, "refreshed_found_at_rank1": rank1,
            "refreshed_queries": len(found), "superseded_returned": stale_seen,
            "refresh_thread_stopped": not poller_alive,
            "launches_warm": delta(c0, c_warm), "launches_served": delta(c_warm, c_served),
            "launches": delta(c0, c1)}
        emit("catalog_cli", step="serve", **out["serve"], gpu=gpu)
        if not (out["serve"]["all_200"] and np.mean(overlaps) >= 0.9 and num_live == n + n_new
                and refresh_s < 60 and rank1 == n_new + n_regen and stale_seen == 0
                and not poller_alive):
            raise AssertionError(f"serve: {out['serve']}")
        for key, name in (("mips_g_scan", "B1"), ("fused_attn_int8_layer", "B3"),
                          ("fused_mlp_int8_layer", "B4")):
            if c_served[key] - c_warm[key] < 1:
                launch_faults.append(f"serve: the served requests never launched {name} "
                                     f"{delta(c_warm, c_served)}")
        del srv, sched, live, direct, be8
        gc.collect()

        # 6. restart: a fresh engine from the same catalog and spool
        t0 = time.perf_counter()
        engine2 = build_engine_from_catalog(cat, be.for_role("document"), spool, device=dev)
        rebuild_s = time.perf_counter() - t0
        latest = {int(r[0]) for r in cat.conn.execute(
            "SELECT MAX(slogan_id) FROM theorem_slogan GROUP BY theorem_id")}
        sids2, corpus2 = spool_corpus(spool, dev, keep=latest)
        with aside():
            recalls2 = min_recall(engine2, corpus2, dev)
        m2 = engine2.meta
        theorems = len(set(zip(m2.paper_id, m2.theorem_name)))
        by_id = dict(cat.conn.execute("SELECT slogan_id, slogan FROM theorem_slogan"))
        packed_latest = list(m2.slogan) == [by_id[int(i)] for i in sids2]
        out["restart"] = {"seconds": rebuild_s, "rows": engine2.n_valid,
                          "spooled_rows": IndexBuilder(spool).total_rows,
                          "one_doc_per_theorem": theorems == engine2.n_valid,
                          "packed_are_latest": packed_latest,
                          "global_scale": engine2._global_scale,
                          "route_counts": dict(engine2.route_counts), "recall_draws": recalls2,
                          "recall_min": min(recalls2)}
        emit("catalog_cli", step="restart", **out["restart"], gpu=gpu)
        if not (engine2.n_valid == n + n_new and theorems == engine2.n_valid and packed_latest
                and set(engine2.route_counts) == {"speed"}
                and min(recalls2) >= 0.99):
            raise AssertionError(f"restart: {out['restart']}")
        del engine2, corpus2
        gc.collect()

        # 7. build-ivf --calibrate on the same spool
        c0 = snap()
        t0 = time.perf_counter()
        index, (nprobe, ivf_recall) = cli_run(["--catalog", db, "build-ivf", "--spool", spool,
                                               "--calibrate", "--out", ivf_out])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ivf_s = time.perf_counter() - t0
        c1 = snap()
        out["ivf"] = {"seconds": ivf_s, "rows": index.num_rows, "lists": int(index.slabs.shape[0]),
                      "nprobe": nprobe, "recall_min": ivf_recall, "launches": delta(c0, c1)}
        emit("catalog_cli", step="build_ivf", **out["ivf"], gpu=gpu)
        if not (ivf_recall >= 0.99 and index.num_rows == n + n_new + n_regen):
            raise AssertionError(f"build-ivf: {out['ivf']}")
        if c1["ivf_probe_scores"] - c0["ivf_probe_scores"] < 1:
            launch_faults.append(f"build-ivf: B6 never launched {delta(c0, c1)}")
        del index, be
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # 8. train from the checkpoint on catalog pairs
        c0 = snap()
        t0 = time.perf_counter()
        losses = cli_run(["train", "--model-dir", model_dir, "--catalog", db, "--catalog-limit",
                          "4096", "--steps", str(train_steps), "--batch-size", "64", "--seq-len",
                          "64", "--checkpoint-dir", ck_dir])
        train_s = time.perf_counter() - t0
        c1 = snap()
        d = delta(c0, c1)
        out["train"] = {"seconds": train_s, "losses": losses, "checkpoint_files": os.listdir(ck_dir),
                        "launches": d}
        emit("catalog_cli", step="train", **out["train"], gpu=gpu)
        if not (len(losses) == train_steps and all(np.isfinite(losses)) and os.listdir(ck_dir)):
            raise AssertionError(f"train: {out['train']}")
        want = 2 * cfg.num_layers * train_steps
        if (d.get("qknorm_rope_attention"), d.get("qknorm_rope_attention_bwd")) != (want, want):
            launch_faults.append(f"train: B2/B7 launched {d}, want {want} each")

        # 9. eval and compare-embedders on the checkpoint
        t0 = time.perf_counter()
        metrics = cli_run(["eval", "--model-dir", model_dir])
        results = cli_run(["compare-embedders", "--families", "qwen", "--model-dir", model_dir])
        out["eval"] = {"seconds": time.perf_counter() - t0, "metrics": metrics,
                       "compare": {r.name: r.metrics for r in results}}
        emit("catalog_cli", step="eval", **out["eval"], gpu=gpu)
        values = list(metrics.values()) + [v for r in results for v in r.metrics.values()]
        if not (len(results) == 2 and all(np.isfinite(values))):
            raise AssertionError(f"eval: {out['eval']}")
        cat.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if launch_faults:
        raise AssertionError("catalog_cli launches: " + "; ".join(launch_faults))
    return out


def rows_equal_or_better(got, ref, oracle) -> tuple[float, int, int]:
    """(share of equal ids, rows that differ, rows where `got` is worse):
    two (B, k) id lists held to each other, a differing row counted worse
    when it finds fewer of the oracle's k neighbours than `ref`'s row."""
    got, ref, oracle = (np.asarray(a) for a in (got, ref, oracle))
    differ = (got != ref).any(axis=1)
    worse = 0
    for r in np.nonzero(differ)[0]:
        worse += len(set(got[r]) & set(oracle[r])) < len(set(ref[r]) & set(oracle[r]))
    return float((got == ref).mean()), int(differ.sum()), int(worse)


def mesh_phases(dev, gpu: str, counters: dict, path_start, path_end, *, index, rindex, corpus,
                corpus_dev, qd, oracle, meta, f3, f36, host_masks, xindex, rescore_bf16, engine, xeng,
                ivf, ivf_corpus, flat_ivf, draws, nprobe, params, cfg, encoder, encoder8, texts,
                serve_round, n_add: int = 10_240, n_del: int = 1_000, n_del_delta: int = 100,
                requests: int = 128) -> dict:
    """Phases mesh_search, mesh_live, mesh_ivf and mesh_serve: the serving
    paths row-sharded over four shards of the one card ([dev] * 4), at
    the main phases' full widths (B=512 where phase 9 and the live phase
    run it), reusing their
    indexes, corpora, oracles, filters and encoders; each held to its
    single-device engine. Every window counts the mesh path alone: the
    single-device runs and oracles it is held to run outside the windows
    or are counted apart (`aside`). Returns the launch windows by phase;
    raises if a gate fails."""
    import torch

    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
    from theoremsearch_tpu_torch.eval.oracle import exact_topk
    from theoremsearch_tpu_torch.index.flat import l2_normalize_rows
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.serve.app import SearchService
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

    shards, batch = 4, 512
    mesh = make_mesh(MeshConfig(shard=shards), devices=[dev] * shards)
    nc, d = int(index.num_rows), int(corpus_dev.shape[1])
    windows = {}

    def counted(fn, aside):
        """fn() with its launches added to `aside` (taken out of the window)."""
        before = {n: c.n for n, c in counters.items()}
        out = fn()
        for n, c in counters.items():
            aside[n] = aside.get(n, 0) + c.n - before[n]
        return out

    def wall_ms(eng, qq, n=8):
        eng.search_vectors(qq, k=10)
        t0 = time.perf_counter()
        for _ in range(n):
            eng.search_vectors(qq, k=10)
        return (time.perf_counter() - t0) * 1e3 / n

    def overlap(a, b):
        return float(np.mean([len(set(x) & set(y)) / a.shape[1] for x, y in zip(a, b)]))

    # ---- mesh_search: phase 6's index on the mesh, B=1024 draws ----
    t0 = time.perf_counter()
    meng = SearchEngine(index, meta=meta, rescore_vectors=corpus, mesh=mesh)
    build_s = time.perf_counter() - t0
    path_start()
    got = [meng.search_vectors(qd[s], k=10) for s in range(len(qd))]
    win_u = path_end()
    nq = qd[0].shape[0]
    recalls = [recall_vs_exact(i_, oracle[s * nq : (s + 1) * nq], k=10) for s, (_, i_) in enumerate(got)]
    single = [engine.search_vectors(qd[s], k=10) for s in range(len(qd))]
    overlaps = [overlap(g[1], s1[1]) for g, s1 in zip(got, single)]
    # scores at equal ids within 5e-3 (the reference's bar); rows whose ids
    # differ must not find fewer true neighbours than the single device's
    same_id = [g[1] == s1[1] for g, s1 in zip(got, single)]
    score_diff = max(float(np.abs(g[0] - s1[0])[m_].max(initial=0.0))
                     for g, s1, m_ in zip(got, single, same_id))
    score_diff_any = max(float(np.abs(g[0] - s1[0]).max()) for g, s1 in zip(got, single))
    vs_single = [rows_equal_or_better(g[1], s1[1], oracle[s * nq : (s + 1) * nq])
                 for s, (g, s1) in enumerate(zip(got, single))]
    # the year mask (masked route) and the 36-signature mix (grouped, split
    # 32 + 4): len(f36) batches, row r of batch b under signature (r + b)
    # mod 36, so each signature sees every query once
    qf = unit_rows(batch, d, 2000, dev)
    n_sig = len(f36)
    r0 = dict(meng.route_counts)
    path_start()
    _, yid = meng.search_vectors(qf, k=10, filters=f3[0])
    gids = [meng.search_vectors(qf, k=10, filters=[f36[(r + b) % n_sig] for r in range(batch)])[1]
            for b in range(n_sig)]
    win_f = path_end()
    routes = {r: c - r0.get(r, 0) for r, c in meng.route_counts.items() if c > r0.get(r, 0)}
    year_ok = bool(host_masks[0][yid[yid >= 0]].all()) and bool((yid >= 0).all())
    year_rec = recall_vs_exact(yid, exact_topk(qf, corpus_dev, k=10, device=dev, mask=host_masks[0])[1], k=10)
    sig_rec, sig_ok = {}, True
    for s_ in range(n_sig):
        mk = host_masks[3 + s_]
        got_s = np.concatenate([gids[b][(s_ - b) % n_sig :: n_sig] for b in range(n_sig)])
        rows_s = np.concatenate([np.arange(batch)[(s_ - b) % n_sig :: n_sig] for b in range(n_sig)])
        orc = exact_topk(qf, corpus_dev, k=10, device=dev, mask=mk)[1][rows_s]
        sig_rec[s_] = recall_vs_exact(got_s, orc, k=10)
        sig_ok &= bool(mk[got_s[got_s >= 0]].all())
    # the exact route (B5 a shard) at k=40, unfiltered and year-filtered
    xm = SearchEngine(xindex, meta=meta, rescore_vectors=rescore_bf16, mesh=mesh)
    path_start()
    x_got = [xm.search_vectors(qf, k=40), xm.search_vectors(qf, k=40, filters=f3[0])]
    win_x = path_end()
    x_ref = [xeng.search_vectors(qf, k=40), xeng.search_vectors(qf, k=40, filters=f3[0])]
    exact_equal = [topk_agree(*(torch.from_numpy(np.asarray(a_)) for a_ in (g_[0], g_[1], r_[0], r_[1])),
                              exact=False)[0] for g_, r_ in zip(x_got, x_ref)]
    del xm
    # the residual mode, both levels sharded
    rm = SearchEngine(rindex, mesh=mesh)
    path_start()
    r_got = [rm.search_vectors(qd[s], k=10)[1] for s in range(len(qd))]
    win_r = path_end()
    r_rec = [recall_vs_exact(i_, oracle[s * nq : (s + 1) * nq], k=10) for s, i_ in enumerate(r_got)]
    resid_mode = rm._speed_ok and rm._shards[0]["res_codes"] is not None
    del rm
    qpad = qd[0].contiguous()
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        meng._speed_search(qpad, 10, 10)
        torch.cuda.synchronize()
    prof_rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:8]
    mesh_profile = [[e.key[:60], round(e.self_device_time_total, 1), e.count] for e in prof_rows]
    batch_ms = {"mesh_device": cuda_ms(lambda: meng._speed_search(qpad, 10, 10), 10),
                "single_device": cuda_ms(lambda: engine._speed_search(qpad, 10, 10), 10),
                "mesh_wall": wall_ms(meng, qd[0]), "single_wall": wall_ms(engine, qd[0])}
    cards = None
    if torch.cuda.device_count() > 1:
        # the same engine over the distinct cards (not the driver's one-card run)
        cmesh = make_mesh(MeshConfig(shard=min(shards, torch.cuda.device_count())),
                          devices=[torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        ceng = SearchEngine(index, rescore_vectors=corpus, mesh=cmesh)
        c_got = [ceng.search_vectors(qd[s], k=10)[1] for s in range(len(qd))]
        cards = {"devices": [str(x) for x in cmesh.shard_devices],
                 "recall_min": min(recall_vs_exact(i_, oracle[s * nq : (s + 1) * nq], k=10)
                                   for s, i_ in enumerate(c_got)),
                 "ids_equal_one_card_mesh": float(np.mean([(a == b[1]).mean() for a, b in zip(c_got, got)]))}
        del ceng
    n_q = len(qd)
    emit("mesh_search", shards=shards, devices=[str(x) for x in mesh.shard_devices], rows=nc,
         rows_per_shard=meng.rows_per_shard, build_s=round(build_s, 3), recall_draws=recalls,
         recall_min=min(recalls), overlap10_single_min=min(overlaps),
         max_score_diff_single_same_id=score_diff, max_score_diff_single_by_position=score_diff_any,
         rows_differing_single=sum(v[1] for v in vs_single),
         rows_worse_than_single=sum(v[2] for v in vs_single), profile_b1024_us=mesh_profile,
         year_recall=year_rec, year_all_pass=year_ok, grouped_recall_min=min(sig_rec.values()),
         grouped_all_pass=sig_ok, routes=routes, exact_b512_k40_ids_equal_single=exact_equal,
         residual_recall_min=min(r_rec), batch_ms_b1024=batch_ms, other_cards=cards, gpu=gpu,
         launches={"unmasked": win_u, "filtered": win_f, "exact": win_x, "residual": win_r})
    if not (min(recalls) >= 0.99 and min(overlaps) >= 0.99 and score_diff <= 5e-3
            and sum(v[2] for v in vs_single) == 0 and year_ok
            and year_rec >= 0.99 and sig_ok and min(sig_rec.values()) >= 0.99 and all(exact_equal)
            and resid_mode and min(r_rec) >= 0.99 and routes == {"masked": 1, "grouped": 2 * n_sig}
            and (cards is None or cards["recall_min"] >= 0.99)):
        raise AssertionError("mesh_search phase failed")
    if not (win_u["mips_g_scan"] == shards * n_q and win_f["mips_g_scan_mask"] == shards
            and win_f["mips_g_scan_gmask"] == 2 * shards * n_sig and win_x["mips_topk"] == 2 * shards
            and win_r["mips_g_scan"] == shards * n_q):
        raise AssertionError(f"mesh_search: a kernel did not run once a shard a batch: "
                             f"{win_u}, {win_f}, {win_x}, {win_r}")
    windows["mesh_search"] = {"unmasked": win_u, "filtered": win_f, "exact": win_x, "residual": win_r}

    # ---- mesh_live: adds, deletes, an update, compact and reclaim on the
    # meshed engine, each step held to a single-device engine ----
    lm = SearchEngine(index, rescore_vectors=corpus, mesh=mesh)
    l1 = SearchEngine(index, rescore_vectors=corpus, device=dev)
    qlive = [q_[:batch].contiguous() for q_ in qd]
    add_vecs = l2_normalize_rows(unit_rows(n_add, d, 50_000, dev).cpu())
    live_rows = torch.cat([corpus_dev, add_vecs.to(dev)])
    alive = np.zeros(nc + n_add, bool)
    alive[:nc] = True
    aside: dict = {}
    steps = {}

    def check(step):
        """Mesh vs single-device ids on every draw, against the oracle over
        the live rows; no dead id returned."""
        eq, differ, worse, recs, dead_ok = [], 0, 0, [], True
        for qq in qlive:
            _, im = lm.search_vectors(qq, k=10)
            _, i1 = counted(lambda: l1.search_vectors(qq, k=10), aside)
            orc = counted(lambda: exact_topk(qq, live_rows, k=10, device=dev, mask=alive)[1], aside)
            e_, d_, w_ = rows_equal_or_better(im, i1, orc)
            eq.append(e_)
            differ += d_
            worse += w_
            recs.append(recall_vs_exact(im, orc, k=10))
            dead_ok &= bool(alive[im[im >= 0]].all()) and bool((im >= 0).all())
        steps[step] = {"ids_equal": min(eq), "rows_differing": differ, "rows_worse": worse,
                       "recall_min": min(recs), "no_dead_id": dead_ok}

    def compact_under_load(reclaim):
        lat, stop_ = [], threading.Event()
        qc = qlive[2][:64].contiguous()

        def client():
            while not stop_.is_set():
                t_ = time.perf_counter()
                lm.search_vectors(qc, k=10)
                lat.append((t_, time.perf_counter() - t_))

        th = threading.Thread(target=client)
        th.start()
        time.sleep(0.3)
        t_c = time.perf_counter()
        folded = lm.compact(reclaim=reclaim)
        t_e = time.perf_counter()
        time.sleep(0.1)
        stop_.set()
        th.join()
        during = [d_ for t_, d_ in lat if t_ + d_ >= t_c and t_ <= t_e]
        return folded, {"seconds": round(t_e - t_c, 3), "queries_during": len(during),
                        "longest_query_ms": round(1e3 * max(during, default=0.0), 1)}

    path_start()
    check("baseline")
    t0 = time.perf_counter()
    for i in range(0, n_add, 1024):
        ids_m = lm.add_documents(add_vecs[i : i + 1024].numpy(), normalize=False)
        ids_1 = counted(lambda: l1.add_documents(add_vecs[i : i + 1024].numpy(), normalize=False), aside)
        if not np.array_equal(ids_m, ids_1):
            raise AssertionError("mesh_live: the add minted other ids")
    add_s = time.perf_counter() - t0
    alive[nc:] = True
    check("after_add")
    gdel = np.random.default_rng(60)
    deleted = np.concatenate([gdel.choice(nc, n_del, replace=False),
                              nc + gdel.choice(n_add, n_del_delta, replace=False)])
    if lm.delete_documents(deleted) != deleted.size or l1.delete_documents(deleted) != deleted.size:
        raise AssertionError("mesh_live: a delete missed a live doc")
    alive[deleted] = False
    check("after_delete")
    upd = int(np.nonzero(alive[:nc])[0][12_345 % int(alive[:nc].sum())])
    new_vec = l2_normalize_rows(unit_rows(1, d, 50_001, dev).cpu())
    lm.update_document(upd, new_vec.numpy())
    l1.update_document(upd, new_vec.numpy())
    live_rows[upd] = new_vec[0].to(dev)
    check("after_update")
    folded, comp = compact_under_load(False)
    if folded != counted(lambda: l1.compact(), aside):
        raise AssertionError("mesh_live: compact folded another count")
    check("after_compact")
    _, recl = compact_under_load(True)
    counted(lambda: l1.compact(reclaim=True), aside)
    map_equal = bool(np.array_equal(lm.last_id_map, l1.last_id_map))
    keep_old = np.nonzero(lm.last_id_map >= 0)[0]
    live_rows = live_rows[torch.from_numpy(keep_old).to(dev)]
    alive = np.ones(keep_old.size, bool)
    check("after_reclaim")
    win_l = path_end(aside=aside)
    emit("mesh_live", shards=shards, batch=batch, added=n_add, add_s=round(add_s, 3),
         deleted_main=n_del, deleted_delta=n_del_delta, updated=upd, compact=comp, reclaim=recl,
         id_map_equal_single=map_equal, rows_after=lm.n_valid, steps=steps, gpu=gpu, launches=win_l)
    if not (map_equal and lm.n_valid == l1.n_valid == nc + n_add - n_del - n_del_delta
            and all(st_["no_dead_id"] and st_["rows_worse"] == 0 and st_["recall_min"] >= 0.99
                    for st_ in steps.values())):
        raise AssertionError("mesh_live phase failed")
    if win_l["mips_g_scan"] < shards or win_l["mips_g_scan"] % shards:
        raise AssertionError(f"mesh_live: B1 did not run once a shard: {win_l}")
    windows["mesh_live"] = win_l
    del lm, l1, live_rows

    # ---- mesh_ivf: the 1M clustered IVF index, lists sharded over the mesh ----
    t0 = time.perf_counter()
    ieng = SearchEngine(flat_ivf, rescore_vectors=ivf_corpus, mesh=mesh, ivf_index=ivf, ivf_nprobe=nprobe)
    ibuild_s = time.perf_counter() - t0
    single_fn = ivf.device_searcher(k=10, nprobe=nprobe)
    r0 = ieng.route_counts.get("ivf", 0)
    path_start()
    i_got = [np.concatenate([ieng.search_vectors(qq[j : j + 8], k=10)[1] for j in range(0, qq.shape[0], 8)])
             for qq, _ in draws]
    win_i = path_end()
    n_batches = ieng.route_counts.get("ivf", 0) - r0
    i_rec = [recall_vs_exact(g_, orc, k=10) for g_, (_, orc) in zip(i_got, draws)]
    i_cmp = [rows_equal_or_better(g_, torch.cat([single_fn(qq[j : j + 8])[1] for j in range(0, qq.shape[0], 8)])
                                  .cpu().numpy(), orc) for g_, (qq, orc) in zip(i_got, draws)]
    qb8 = draws[0][0][:8].contiguous()
    ivf_ms = {"mesh_device": cuda_ms(lambda: ieng._ivf_fn(10)(qb8), 20),
              "single_device": cuda_ms(lambda: single_fn(qb8), 20),
              "mesh_wall": wall_ms(ieng, qb8, n=20)}
    emit("mesh_ivf", shards=shards, nprobe=nprobe, build_s=round(ibuild_s, 3), recall_b8_draws=i_rec,
         recall_b8_min=min(i_rec), ids_equal_single=min(c_[0] for c_ in i_cmp),
         rows_differing=sum(c_[1] for c_ in i_cmp), rows_worse=sum(c_[2] for c_ in i_cmp),
         ivf_batches=n_batches, batch_ms_b8=ivf_ms, gpu=gpu, launches=win_i)
    if not (min(i_rec) >= 0.99 and sum(c_[2] for c_ in i_cmp) == 0 and n_batches == sum(
            -(-qq.shape[0] // 8) for qq, _ in draws)):
        raise AssertionError("mesh_ivf phase failed")
    if win_i["ivf_probe_scores"] != shards * n_batches:
        raise AssertionError(f"mesh_ivf: B6 did not run once a shard a batch: {win_i}")
    windows["mesh_ivf"] = win_i
    ieng.ivf._sharded_cache = None
    del ieng, single_fn

    # ---- mesh_serve: scheduler + HTTP over the meshed engine, the int8
    # encoder data-parallel over [dev] * 2 ----
    dmesh = make_mesh(MeshConfig(data=2), devices=[dev] * 2)
    dp8 = BatchedEncoder(params, cfg, batch_size=512, quant="int8", mesh=dmesh)
    dp16 = BatchedEncoder(params, cfg, batch_size=512, mesh=dmesh)
    sample = texts[:512]
    cos8 = float(np.min(np.sum(dp8.encode(sample) * encoder8.encode(sample), axis=1)))
    cos16 = float(np.min(np.sum(dp16.encode(sample) * encoder.encode(sample), axis=1)))
    del dp16
    sched = BatchScheduler(meng, max_batch=256, encode_fn=dp8.encode_device)
    service = SearchService(meng, dp8.encode, scheduler=sched)
    direct = SearchService(engine, encoder8.encode)
    qtexts = [texts[(37 * i) % len(texts)] for i in range(requests)]
    r0 = dict(meng.route_counts)
    path_start()
    answers, serve_s, st, warm = serve_round(service, [{"query": t_, "top_k": 10} for t_ in qtexts])
    win_s = path_end()
    scans = sum(c - r0.get(r, 0) for r, c in meng.route_counts.items())
    codes_ok = all(code == 200 for code, _ in answers)
    over = []
    for text, (_, body) in zip(qtexts, answers):
        want = {r["doc_id"] for r in direct.search_and_display(text)}
        over.append(len({r["doc_id"] for r in body["results"]} & want) / 10)
    nb = st["batches"] - warm["batches"]
    emit("mesh_serve", shards=shards, data=2, requests=len(answers), all_200=codes_ok,
         overlap10_single_mean=float(np.mean(over)), overlap10_single_min=float(np.min(over)),
         cos_dp_vs_one_device_int8_min=cos8, cos_dp_vs_one_device_bf16_min=cos16,
         wall_s=round(serve_s, 3), batches=nb, scans_in_window=scans,
         latency_ms=st.get("latency_ms"), stages_ms={
             k: v for k, v in st.get("stages_ms", {}).items() if k != "worst_batches"},
         gpu=gpu, launches=win_s)
    if not (codes_ok and np.mean(over) >= 0.9 and cos8 >= 0.999 and cos16 >= 0.9999
            and len(answers) == requests):
        raise AssertionError("mesh_serve phase failed")
    if not (win_s["mips_g_scan"] == shards * scans and scans >= 1 and win_s["fused_attn_int8_layer"] >= 1
            and win_s["fused_mlp_int8_layer"] >= 1):
        raise AssertionError(f"mesh_serve: a kernel of the meshed serving path did not run: {win_s}")
    windows["mesh_serve"] = win_s
    return windows


# mesh_encode_tp's towers: (name, config overrides, shards, seed)
TP_TOWERS = (("qwen", dict(vocab_size=151_936, max_seq_len=128), 4, 61),
             ("gemma", dict(max_seq_len=128), 2, 62),
             ("bert", dict(max_seq_len=128), 2, 63))
# mesh_train's tower (config overrides), its steps, and the global
# batches (pairs) it tries in turn
MESH_TRAIN_CFG = dict(vocab_size=151_936, max_seq_len=64)
MESH_TRAIN_STEPS = 6
MESH_TRAIN_PAIRS = (64, 32)


def train_tokens(rng, vocab_size: int, pairs: int, seq: int, steps: int) -> tuple:
    """Phase 18's token batches, (steps, pairs, seq) int32 each: one random
    template, with each pair's own identity tokens at positions 1.. of the
    query and 2.. of the positive (drawn from `rng`, which goes on)."""
    template = rng.integers(3, vocab_size, seq).astype(np.int32)
    ident = max(2, seq // 16)
    tq = np.broadcast_to(template, (steps, pairs, seq)).copy()
    tp = tq.copy()
    id_toks = rng.integers(3, vocab_size, (steps, pairs, ident))
    tq[:, :, 1 : 1 + ident] = id_toks
    tp[:, :, 2 : 2 + ident] = id_toks
    return tq, tp


def tp_f32_distance(mod, params, cfg, mesh, texts, dev) -> float:
    """The same tower in f32 throughout (params, activations, the reference
    composition, TF32 off) on `texts` padded to 64 tokens, through its tp
    forward on `mesh` and unsharded: the largest row distance of the two
    sets of pooled unit rows. f32 rounding keeps it near 1e-6 at full
    depth; a head, block or sum misplaced in the tp forward shows at any
    precision, where bf16's own rounding (the 0.999 gate) might hide it."""
    import torch

    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer
    from theoremsearch_tpu_torch.utils.device import tf32_off

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = {k: v.float() for k, v in params.items() if k != "layers"}
    p32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
    enc = SimpleTokenizer(vocab_size=cfg.vocab_size)(texts, max_length=64, pad_to=64)
    ids = torch.from_numpy(enc.input_ids).to(dev)
    am = torch.from_numpy(enc.attention_mask).to(dev)
    with torch.inference_mode(), tf32_off():
        one = mod.encode_pooled(p32, ids, am, cfg32, fused="off")
        tp = mod.encode_pooled(mod.shard_params(p32, mesh), ids, am, cfg32, fused="off")
    return float((tp.double() - one.double()).norm(dim=1).max())


def mesh_encode_tp(dev, gpu: str, counters: dict, path_start, path_end, *, texts,
                   batch_size=512) -> dict:
    """Phase mesh_encode_tp: tensor-parallel encoding at full width on
    repeated entries of one card. Each tower's params placed by its
    `shard_params` go through `BatchedEncoder(mesh=)` against the same
    params on one device: qwen bf16 (vocab 151,936: the Qwen3 family's
    padded vocabulary, since the reference's vocab sharding refuses the
    odd 151,669) on (1, 4), its 16/8 heads head-local at 4/2 a shard (B2
    once a shard a layer a batch); gemma on (1, 2), its 3/1 heads gathered
    on the first device (B2's gemma form once a layer a batch); BERT-base
    on (1, 2), no kernel. Gates: the pooled cosine >= 0.999 (the
    reference's tp gate), the same tower in f32 on the first batch's
    texts at a row distance <= 1e-4 from one device (`tp_f32_distance`,
    outside the launch window), int8 on the tp mesh refused ("dp-only"),
    the launch counts exact. The towers are `TP_TOWERS`. Returns the
    windows."""
    import torch

    from theoremsearch_tpu_torch.core.config import (
        BertEncoderConfig, EncoderConfig, GemmaEncoderConfig, MeshConfig,
    )
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder import bert as bert_mod
    from theoremsearch_tpu_torch.encoder import gemma as gemma_mod
    from theoremsearch_tpu_torch.encoder import model as qwen_mod
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    family = {"qwen": (qwen_mod, EncoderConfig), "gemma": (gemma_mod, GemmaEncoderConfig),
              "bert": (bert_mod, BertEncoderConfig)}
    windows = {}
    n_batches = -(-len(texts) // batch_size)
    for name, overrides, shards, seed in TP_TOWERS:
        mod, cfg = family[name][0], family[name][1](**overrides)
        params = mod.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        if mod is gemma_mod:      # the (1 + w) norm weights off zero
            gn = torch.Generator(device=dev).manual_seed(seed + 100)
            for layer_ in params["layers"]:
                for t_ in layer_.values():
                    if t_.ndim == 1:
                        t_ += 0.1 * torch.randn(t_.shape, generator=gn, device=dev)
        mesh = make_mesh(MeshConfig(data=1, shard=shards), devices=[dev] * shards)
        one = BatchedEncoder(params, cfg, batch_size=batch_size, device=dev)
        tp = BatchedEncoder(mod.shard_params(params, mesh), cfg, batch_size=batch_size, mesh=mesh)
        refused = None
        if hasattr(mod, "quantize_params_int8"):
            try:
                BatchedEncoder(params, cfg, batch_size=batch_size, mesh=mesh, quant="int8")
            except ValueError as e:
                refused = str(e)
        t0 = time.perf_counter()
        e_one = one.encode(texts)
        one_s = time.perf_counter() - t0
        path_start()
        t0 = time.perf_counter()
        e_tp = tp.encode(texts)
        tp_s = time.perf_counter() - t0
        win = path_end()
        cos = float(np.min(np.sum(e_tp.astype(np.float64) * e_one, axis=1)))
        dist32 = tp_f32_distance(mod, params, cfg, mesh, texts[:batch_size], dev)
        # the attention core's heads a call (q, kv) and the launches the
        # encode must make: once a shard a layer a batch where the kv heads
        # divide over the shards, else once a layer a batch, gathered
        if mod is bert_mod:
            layout, heads, want = "no kernel", None, {}
        elif cfg.num_kv_heads % shards == 0:
            layout, heads = "head-local", [cfg.num_heads // shards, cfg.num_kv_heads // shards]
            want = {"qknorm_rope_attention": shards * cfg.num_layers * n_batches}
        else:
            layout, heads = "gathered", [cfg.num_heads, cfg.num_kv_heads]
            kernel = "qknorm_rope_attention_gemma" if mod is gemma_mod else "qknorm_rope_attention"
            want = {kernel: cfg.num_layers * n_batches}
        want = {k: want.get(k, 0) for k in counters}
        emit("mesh_encode_tp", tower=name, shards=shards, layout=layout, heads_a_call=heads,
             vocab=cfg.vocab_size, texts=len(texts), batches=n_batches, cos_tp_vs_one_device_min=cos,
             f32_row_distance_max=dist32,
             encode_s={"tp": round(tp_s, 3), "one_device": round(one_s, 3)},
             int8_refused=refused, finite=bool(np.isfinite(e_tp).all()), launches=win, gpu=gpu)
        if not (cos >= 0.999 and dist32 <= 1e-4 and np.isfinite(e_tp).all() and e_tp.shape == e_one.shape
                and (refused is not None and "dp-only" in refused
                     or not hasattr(mod, "quantize_params_int8"))):
            raise AssertionError(f"mesh_encode_tp ({name}) failed")
        if win != want:
            raise AssertionError(f"mesh_encode_tp ({name}): launches {win}, want {want}")
        windows[name] = win
        del params, one, tp, e_one, e_tp
        torch.cuda.empty_cache()
    return windows


def mesh_train(dev, gpu: str, counters: dict, path_start, path_end, *, tq, tp, tmask) -> dict:
    """Phase mesh_train: the dp + tp train step at full width on a (data=2,
    shard=2) mesh over [cuda:0] * 4 (the mesh `dryrun_multichip(4)`
    builds), fused "on": the qwen tower (vocab 151,936, see
    `mesh_encode_tp`), its 16/8 heads head-local at 8/4 a shard, so B2 and
    B7 run once a shard a layer for each encode (q and p) of each data row:
    224 launches each a step. Weights from one generator go into a
    single-device state and, through `shard_train_state`, into the sharded
    one. Gates: one batch's loss within 2e-2 of the single device's and
    every logical leaf's gradient at cosine >= 0.999; `MESH_TRAIN_STEPS`
    mesh steps with finite losses, each within 2e-2 of the single-device
    trajectory on the same batches (tq[i], tp[i]); the launch counts
    exact. The global batch is `MESH_TRAIN_PAIRS[0]` pairs, or the next
    if the step runs out of memory. Returns the window, the mesh losses
    and the batch (the multi-process train step is held to them)."""
    import gc

    import torch

    from theoremsearch_tpu_torch.core.config import EncoderConfig, MeshConfig, TrainConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.train.contrastive import (
        info_nce_loss, init_train_state, logical_grads, make_train_step, piece_leaves,
        shard_train_state,
    )

    cfg, steps, pairs = EncoderConfig(**MESH_TRAIN_CFG), MESH_TRAIN_STEPS, MESH_TRAIN_PAIRS
    mesh = make_mesh(MeshConfig(data=2, shard=2), devices=[dev] * 4)
    n_shard = mesh.shape["shard"]

    def run(nb: int):
        tc = TrainConfig(batch_size=nb, seq_len=tq.shape[-1], learning_rate=2e-5, temperature=0.05)
        one = init_train_state(cfg, tc, generator=torch.Generator(device=dev).manual_seed(71),
                               device=dev)
        sharded = shard_train_state(one, mesh, cfg)
        batches = [(tq[i][:nb], tmask[:nb], tp[i][:nb], tmask[:nb]) for i in range(steps)]

        def grads(state, m):
            pcs = piece_leaves(state.params)
            for t_ in pcs:
                t_.requires_grad_(True)
            try:
                loss_ = info_nce_loss(state.params, *batches[0], cfg, tc.temperature, "on", mesh=m)
                g_ = torch.autograd.grad(loss_, pcs)
            finally:
                for t_ in pcs:
                    t_.requires_grad_(False)
            return float(loss_.detach()), logical_grads(state.params, list(g_))

        l_one, g_one = grads(one, None)
        l_mesh, g_mesh = grads(sharded, mesh)
        cos = [agreement(a_, b_)[0] for a_, b_ in zip(g_mesh, g_one)]
        del g_one, g_mesh

        def trajectory(state, step_fn, window: bool):
            ls_, ev = [], [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            if window:
                path_start()
            for i_, b_ in enumerate(batches):
                if i_ == 1:
                    ev[0].record()
                state, l_ = step_fn(state, *b_)
                ls_.append(l_)
            ev[1].record()
            ev[1].synchronize()
            win_ = path_end() if window else None
            return [float(l_) for l_ in ls_], ev[0].elapsed_time(ev[1]) / (steps - 1), win_

        losses_one, ms_one, _ = trajectory(one, make_train_step(cfg, tc, fused="on"), False)
        losses_mesh, ms_mesh, win_ = trajectory(sharded, make_train_step(cfg, tc, mesh=mesh, fused="on"),
                                                True)
        return l_one, l_mesh, cos, losses_one, ms_one, losses_mesh, ms_mesh, win_

    start_gb = torch.cuda.memory_allocated() / 2**30   # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    result = None
    for nb in pairs:
        try:
            result = run(nb)
        except torch.cuda.OutOfMemoryError:
            if nb == pairs[-1]:
                raise
        if result is not None:
            break
        # out of the handler, so the failed step's tensors are unreferenced
        gc.collect()
        torch.cuda.empty_cache()
        emit("mesh_train", step="out of memory", batch_pairs=nb, gpu=gpu)
    l_one, l_mesh, cos, losses_one, ms_one, losses_mesh, ms_mesh, win = result
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.num_layers
    per_step = {k_: v_ / steps for k_, v_ in win.items()}
    want = 2 * n_shard * 2 * layers     # data rows x shards x (q, p) x layers
    drift = max(abs(a_ - b_) for a_, b_ in zip(losses_mesh, losses_one))
    tokens = 2 * nb * tq.shape[-1]
    emit("mesh_train", mesh=[2, n_shard], layers=layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
         heads_a_shard=[cfg.num_heads // n_shard, cfg.num_kv_heads // n_shard], batch_pairs=nb,
         seq_len=int(tq.shape[-1]), steps=steps,
         loss_one_batch={"mesh": l_mesh, "one_device": l_one},
         grad_cos_min=min(cos), grad_leaves=len(cos), losses_mesh=losses_mesh,
         losses_one_device=losses_one, max_abs_dloss=drift,
         step_ms={"mesh": ms_mesh, "one_device": ms_one},
         tokens_per_s={"mesh": tokens / ms_mesh * 1e3, "one_device": tokens / ms_one * 1e3},
         peak_mem_gb=peak_gb, mem_at_start_gb=start_gb, launches=win, launches_per_step=per_step,
         gpu=gpu)
    if not (abs(l_mesh - l_one) <= 2e-2 and min(cos) >= 0.999 and all(np.isfinite(losses_mesh))
            and drift <= 2e-2):
        raise AssertionError("mesh_train phase failed")
    if not (win["qknorm_rope_attention"] == steps * want
            and win["qknorm_rope_attention_bwd"] == steps * want):
        raise AssertionError(f"mesh_train: B2 / B7 not once a shard a layer: {per_step}, want {want}")
    return {"window": win, "losses": losses_mesh, "batch_pairs": nb}


# the multiproc phases' sizes: the worker's size arguments, and the
# encoder configs by the worker's names ("qwen" is MESH_TRAIN_CFG's tower)
MP_SEARCH = ["--n", "1048576", "--d", "1024", "--batch", "1024", "--k", "10", "--row-block", "0",
             "--rescore-factor", "4"]
MP_MORE = ["--recall-draws", "5", "--exact-batch", "512", "--time-iters", "5",
           "--live-adds", "10240", "--live-deletes", "1100", "--ivf-rows", "262144",
           "--ivf-nlist", "1024", "--ivf-nprobe", "32", "--ivf-batch", "8",
           "--encode-config", "qwen512", "--encode-seed", "1", "--encode-quant", "int8",
           "--encode-batch", "512", "--encode-buckets", "64,128,256,512"]
MP_TRAIN = ["--train-config", "qwen", "--train-seed", "71", "--lr", "2e-5", "--temperature", "0.05",
            "--fused", "on"]
MP_TRAIN_STEPS = 3
MP_TIMEOUT_S = 420
# the Gloo train step against the one-process (2, 2) mesh process 0 runs
# itself (`train_readings`): the largest loss difference, the relative
# difference of the gradient norms the updates read (the first step's,
# and the largest), and the final params' distance over the distance the
# one-process params moved. Set from tools/torch_mp_train_probe.py on an
# H100 (PERF.md, PR 14), readings in that order: the sound run 1.22e-5,
# 1.07e-5, 0.0146, 0.0711; twice the sum 3.07e-5, 1.0, 1.0, 0.135 (AdamW
# does not see a gradient's scale); no sum 9.26e-4, 0.460, 0.460, 0.748.
MP_TRAIN_LIMITS = {"max_loss_delta": 1e-4, "first_grad_norm_rel": 1e-3, "max_grad_norm_rel": 0.1,
                   "param_distance_rel": 0.25}


def mp_worker():
    """tests/torch_multihost_worker.py of this checkout, as a module (its
    `run_workers` starts the processes and waits for them)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_multihost_worker

    return torch_multihost_worker


def multiproc_phases(dev, gpu: str, *, texts, tq, tp, mesh_losses) -> None:
    """Phases multiproc_gloo, multiproc_nccl and multiproc_tp
    (`multiproc_tp`, on the same batch): the port's run across processes
    (`core/distributed.py`), each process a tests/torch_multihost_worker.py
    on this card.

    multiproc_gloo: two processes over Gloo (NCCL refuses two ranks on one
    card), both on cuda:0, each holding two mesh entries, so CUDA tensors
    cross the boundary through host memory. The 1,048,576 x 1024 speed
    path at B=1024 over the (1, 4) mesh (2 shards a process) and the exact
    route (B5) at B=512, each bit-equal across the processes and to a
    one-process [cuda:0] * 4 engine, min recall@10 over 5 draws >= 0.99,
    B1 and B5 exactly 2 a batch in each process; 10,240 adds, an update,
    1,100 deletes and compact(reclaim=True), identical across the
    processes; the list-sharded IVF searcher at B=8 on a 262,144 x 1024
    clustered corpus (built once by process 0, loaded by both), equal to
    the one-process sharded searcher (B6 2 a batch); an int8 dp encode of
    4,096 slogans with the full-width qwen tower over a (4, 1) mesh, pooled
    cosine >= 0.9999 against one device (B3, B4); the dp + tp train step
    of mesh_train (qwen, vocab 151,936, its batch and seed) on (data 2,
    shard 2), one data row a process: losses identical across the
    processes, the first within 1e-3 of mesh_train's and all within 5e-3,
    params bit-identical, B2 and B7 112 a step in each process; against
    the one-process (2, 2) mesh that process 0 runs itself on the same
    batches, the first loss equal and the losses, the gradient norms the
    updates read and the final params within `MP_TRAIN_LIMITS`; in each
    process the Gloo sum of a bf16 CUDA tensor of the gradients' size,
    staged through the host, bit-equal to the f32 sum of the gathered
    tensors cast back.

    multiproc_nccl: one process over NCCL (world 1: the backend a
    multi-card deployment uses, on CUDA tensors) on four entries of
    cuda:0: the speed search and one train step bit-equal to the
    one-process mesh, and one speed-path batch under
    `utils/profiling.trace`, whose Chrome trace must name B1's kernel."""
    import shutil
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        with open(os.path.join(work, "texts.json"), "w") as f:
            json.dump(list(texts), f)
        np.savez(os.path.join(work, "batch.npz"), q=np.ascontiguousarray(tq),
                 p=np.ascontiguousarray(tp))
        train = [*MP_TRAIN, "--train-mesh", "2,2", "--train-batch", os.path.join(work, "batch.npz")]
        held = torch.cuda.memory_allocated(dev) / 2**30
        t0 = time.perf_counter()
        W = mp_worker()
        gloo = W.run_workers([
            ["--rank", str(r), "--world", "2", "--init", f"file://{work}/rendezvous_gloo",
             "--device", str(dev), "--backend", "gloo", "--local", "2", "--workdir", work,
             "--parts", "search,live,ivf,encode,train", *MP_SEARCH, *MP_MORE,
             "--encode-texts", os.path.join(work, "texts.json"), *train,
             "--train-steps", str(MP_TRAIN_STEPS), "--check-one-process", "search,ivf,train"]
            for r in range(2)], work, MP_TIMEOUT_S, name="gloo")
        gloo_s = time.perf_counter() - t0
        mp_gloo_gates(gloo, mesh_losses, gpu, gloo_s, held, n_texts=len(texts))
        t0 = time.perf_counter()
        (nccl,) = W.run_workers([
            ["--rank", "0", "--world", "1", "--init", f"file://{work}/rendezvous_nccl",
             "--device", str(dev), "--backend", "nccl", "--local", "4", "--workdir", work,
             "--parts", "search,train", *MP_SEARCH, *train, "--train-steps", "1",
             "--trace-dir", os.path.join(work, "trace"), "--check-one-process", "search,train"]],
            work, MP_TIMEOUT_S, name="nccl")
        mp_nccl_gates(nccl, gpu, time.perf_counter() - t0)
        multiproc_tp(dev, gpu, texts=texts, batch_npz=os.path.join(work, "batch.npz"), work=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _same(results: list, part: str, *keys) -> bool:
    return all(r[part][k] == results[0][part][k] for r in results for k in keys)


def _flag(argv: list, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def _train_layers() -> int:
    from theoremsearch_tpu_torch.core.config import EncoderConfig

    return EncoderConfig(**MESH_TRAIN_CFG).num_layers


def mp_gloo_gates(res: list, mesh_losses: list, gpu: str, seconds: float, held_gb: float,
                  n_texts: int) -> None:
    """Emit multiproc_gloo's line and raise on any gate it misses."""
    steps = MP_TRAIN_STEPS
    s, lv, iv, en, tr = ([r[p] for r in res] for p in ("search", "live", "ivf", "encode", "train"))
    b2_want = steps * 1 * 2 * 2 * _train_layers()   # steps x data rows x shards x (q, p) x layers
    per_rank = [{
        "rank": r["rank"], "search_launches": s_["launches"], "exact_launches": s_["exact"]["launches"],
        "live_launches": l_["launches"], "ivf_launches": i_["launches"],
        "encode_launches": e_["launches"], "train_launches": t_["launches"],
        "recall": s_["recall"], "batch_ms": s_["batch_ms"],
        "search_gather_ms": s_["collectives"]["all_gather"]["s"] * 1e3,
        "encode_s": e_["encode_s"], "encode_cos_vs_one_device": e_["min_cos_vs_one_device"],
        "train_losses": t_["losses"], "step_ms": [x * 1e3 for x in t_["step_s"]],
        "all_reduce_ms": [c["all_reduce"]["s"] * 1e3 for c in t_["collectives_a_step"]],
        "all_reduce_staged_gb": [c["all_reduce"]["staged_bytes"] / 2**30 for c in t_["collectives_a_step"]],
        "all_reduce_stages_ms": [{k: c["all_reduce"].get(k, 0.0) * 1e3
                                  for k in ("pin_s", "to_host_s", "to_device_s")}
                                 for c in t_["collectives_a_step"]],
        "train_gather_ms": [c["all_gather"]["s"] * 1e3 for c in t_["collectives_a_step"]],
        "staged_sum": t_["staged_sum"],
        "peak_mem_gb": t_.get("peak_mem_gb"), "peak_mem_gb_part": t_.get("peak_mem_gb_part"),
        "part_s": {p: r[p]["part_s"] for p in ("search", "live", "ivf", "encode", "train")},
    } for r, s_, l_, i_, e_, t_ in zip(res, s, lv, iv, en, tr)]
    losses = tr[0]["losses"]
    vs_one = tr[0]["vs_one_process"]
    d_first = abs(losses[0] - mesh_losses[0])
    d_all = max(abs(a_ - b_) for a_, b_ in zip(losses, mesh_losses))
    gates = {
        "world_2_gloo_on_cuda": all(r["world"] == 2 and r["backend"] == "gloo" and
                                    r["device"].startswith("cuda") for r in res),
        "search_layout": all(x["layout"] == "shard" and x["n_global_shards"] == 4 and
                             x["sharded_speed_ok"] for x in s),
        "search_equal_across_processes": _same(res, "search", "ids", "scores"),
        "search_equal_one_process": all(x["equal_one_process"] for x in s),
        "recall_min_0.99": min(min(x["recall"]) for x in s) >= 0.99,
        "b1_2_a_batch": all(x["launches"]["mips_g_scan"] == 2 for x in s),
        "exact_equal": all(x["exact"]["ids"] == s[0]["exact"]["ids"]
                           and x["exact"]["scores"] == s[0]["exact"]["scores"]
                           and x["exact"]["equal_one_process"] for x in s),
        "b5_2_a_batch": all(x["exact"]["launches"]["mips_topk"] == 2 for x in s),
        "live_equal_across_processes": _same(res, "live", "live_ids", "live_scores",
                                             "post_reclaim_ids", "post_reclaim_scores",
                                             "folded", "num_live"),
        "live_deletes": all(x["deleted"] == _flag(MP_MORE, "--live-deletes")
                            and not x["deleted_returned"] for x in lv),
        "ivf_equal": _same(res, "ivf", "ids", "scores") and all(x["equal_one_process"] for x in iv),
        "b6_2_a_batch": all(x["launches"]["ivf_probe_scores"] == 2 for x in iv),
        "encode_equal_across_processes": _same(res, "encode", "sha256"),
        "encode_cos_0.9999": all(x["finite"] and x["shape"][0] == n_texts
                                 and x["min_cos_vs_one_device"] >= 0.9999 for x in en),
        "b3_b4_launched": all(x["launches"]["fused_attn_int8_layer"] > 0
                              and x["launches"]["fused_mlp_int8_layer"] > 0 for x in en),
        "train_losses_equal_across_processes": _same(res, "train", "losses"),
        "train_params_bit_identical": _same(res, "train", "params_sha256"),
        "train_first_loss_1e-3": d_first <= 1e-3,
        "train_losses_5e-3": d_all <= 5e-3 and all(np.isfinite(losses)),
        "b2_b7_112_a_step": all(x["launches"]["qknorm_rope_attention"] == b2_want
                                and x["launches"]["qknorm_rope_attention_bwd"] == b2_want for x in tr),
        "train_first_loss_equal_one_process": vs_one["first_loss_equal"],
        "train_within_limits_of_one_process": all(vs_one[k] <= lim
                                                  for k, lim in MP_TRAIN_LIMITS.items()),
        "staged_bf16_sum_bit_equal": all(x["staged_sum"]["bit_equal"]
                                         and x["staged_sum"]["staged_bytes"] > 0 for x in tr),
    }
    emit("multiproc_gloo", processes=2, backend="gloo", entries_a_process=2, gpu=gpu,
         seconds=round(seconds, 3), parent_held_gb=held_gb,
         search_shape=[_flag(MP_SEARCH, f) for f in ("--n", "--d", "--batch")],
         train_losses=losses, mesh_train_losses=list(mesh_losses[:steps]),
         train_first_loss_delta=d_first, train_max_loss_delta=d_all,
         train_one_process=tr[0]["one_process"], train_vs_one_process=vs_one,
         train_limits=MP_TRAIN_LIMITS, per_rank=per_rank, gates=gates)
    missed = [k for k, ok in gates.items() if not ok]
    if missed:
        raise AssertionError(f"multiproc_gloo: gates missed: {missed}")


def mp_nccl_gates(r: dict, gpu: str, seconds: float) -> None:
    """Emit multiproc_nccl's line and raise on any gate it misses."""
    s, t = r["search"], r["train"]
    gates = {
        "world_1_nccl": r["world"] == 1 and r["backend"] == "nccl",
        "search_through_nccl": s["collectives"]["all_gather"]["calls"] == 1
                               and s["layout"] == "local" and s["sharded_speed_ok"],
        "search_equal_one_process": s["equal_one_process"],
        "b1_4_a_batch": s["launches"]["mips_g_scan"] == 4,
        "b2_b7_224_a_step": t["launches"]["qknorm_rope_attention"] == 8 * _train_layers()
                            and t["launches"]["qknorm_rope_attention_bwd"] == 8 * _train_layers(),
        "train_through_nccl": all(c["all_reduce"]["calls"] >= 1 and c["all_gather"]["calls"] == 2
                                  for c in t["collectives_a_step"]),
        "train_equal_one_process": t["equal_one_process"] and all(np.isfinite(t["losses"])),
        "trace_names_b1": any("mips_g_scan_kernel" in k for k in s["trace"]["kernels"]),
    }
    emit("multiproc_nccl", processes=1, backend="nccl", entries=4, gpu=gpu,
         seconds=round(seconds, 3), search_launches=s["launches"], batch_ms=s.get("batch_ms"),
         search_collectives=s["collectives"], train_losses=t["losses"],
         train_one_process_losses=t["one_process"]["losses"], train_vs_one_process=t["vs_one_process"],
         step_ms=[x * 1e3 for x in t["step_s"]], train_collectives=t["collectives_a_step"],
         train_launches=t["launches"], peak_mem_gb=t.get("peak_mem_gb"),
         trace_kernels=s["trace"]["kernels"], part_s={p: r[p]["part_s"] for p in ("search", "train")},
         gates=gates)
    missed = [k for k, ok in gates.items() if not ok]
    if missed:
        raise AssertionError(f"multiproc_nccl: gates missed: {missed}")


# the multiproc_tp phase: (a) the full-width qwen tower's tp path on a
# (1, 2) mesh over two processes, with gemma's gathered encode beside it;
# (b) a (2, 2) mesh over four processes (each data row split over two),
# qwen at 4 layers (depth cut to bound four processes' memory beside the
# parent) and a speed-path batch on a 262,144 x 1024 corpus
MP_TP_ENCODE = {"qwen": 512, "gemma": 64}
MP_TP_STEPS = (3, 2)
MP_TP_SEARCH = ["--n", "262144", "--d", "1024", "--batch", "1024", "--k", "10", "--row-block", "0",
                "--rescore-factor", "4"]


def multiproc_tp(dev, gpu: str, *, texts, batch_npz: str, work: str) -> None:
    """Phase multiproc_tp: tensor parallelism over a shard axis that spans
    processes (ROADMAP A.12), each process a
    tests/torch_multihost_worker.py on this card over Gloo (NCCL refuses
    two ranks on one card), one mesh entry a process.

    (a) MeshConfig(data=1, shard=2) over two processes, the qwen tower at
    full width (28 layers, d 1024, 16/8 heads, vocab 151,936: mesh_train's
    tower), head-local at 8/4 heads a process: the tp encode of 512
    slogans at bucket 64, identical across the processes, pooled cosine
    >= 0.9999 against the one-process [cuda:0] * 2 tp encode and >= 0.999
    against one device (both run by process 0), B2 once a layer; the
    gemma tower (24 layers, 3/1 heads, gathered) encodes 64 slogans at the
    same gates, its B2 form once a layer on every process; mesh_train's
    batch and seed for 3 steps: losses identical across the processes,
    params bit-identical, against the one-process (1, 2) mesh the first
    loss equal and the losses, gradient norms and final params within
    `MP_TRAIN_LIMITS`, B2 and B7 56 a step a process (28 layers x (q, p)
    x one shard); a save_checkpoint that process 0 restores on one device,
    every leaf bit-equal. (b) MeshConfig(data=2, shard=2) over four
    processes: qwen at 4 layers, 2 steps, losses and params identical
    across the four, within `MP_TRAIN_LIMITS` of the one-process (2, 2)
    mesh process 0 runs, B2/B7 8 a step a process; one B=1024 speed-path
    batch on a 262,144 x 1024 corpus, bit-equal across the processes and
    to the one-process (2, 2) engine, B1 once a process. The line carries
    `distributed.stats` by op a step (the row all-reduces and all-gathers:
    calls, bytes, host-staged bytes, seconds), step and encode seconds
    and peak memory a process."""
    W = mp_worker()
    with open(os.path.join(work, "tp_texts.json"), "w") as f:
        json.dump(list(texts[: max(MP_TP_ENCODE.values())]), f)
    common = ["--device", str(dev), "--backend", "gloo", "--local", "1", "--workdir", work,
              "--train-batch", batch_npz, *MP_TRAIN, "--parts"]
    t0 = time.perf_counter()
    a = W.run_workers([
        ["--rank", str(r), "--world", "2", "--init", f"file://{work}/rendezvous_tp_a", *common, "tp",
         "--tp-mesh", "1,2", "--tp-towers", "qwen,gemma", "--tp-train-towers", "qwen",
         "--tp-encode-counts", f"{MP_TP_ENCODE['qwen']},{MP_TP_ENCODE['gemma']}",
         "--encode-texts", os.path.join(work, "tp_texts.json"), "--encode-batch", "512",
         "--encode-buckets", "64", "--train-steps", str(MP_TP_STEPS[0]), "--tp-checkpoint",
         "--check-one-process", "tp"]
        for r in range(2)], work, MP_TIMEOUT_S, name="tp_a")
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = W.run_workers([
        ["--rank", str(r), "--world", "4", "--init", f"file://{work}/rendezvous_tp_b", *common,
         "search,tp", "--search-mesh", "2,2", *MP_TP_SEARCH, "--tp-mesh", "2,2",
         "--tp-towers", "qwen4", "--tp-encode-counts", "0", "--train-steps", str(MP_TP_STEPS[1]),
         "--check-one-process", "search,tp"]
        for r in range(4)], work, MP_TIMEOUT_S, name="tp_b")
    mp_tp_gates(a, b, gpu, a_s, time.perf_counter() - t0)


def _by_op(steps: list) -> list:
    """`distributed.stats` a step, by op: calls, bytes, staged bytes, ms."""
    return [{op: {"calls": e["calls"], "bytes": e["bytes"], "staged_bytes": e["staged_bytes"],
                  "ms": e["s"] * 1e3} for op, e in c.items()} for c in steps]


def mp_tp_gates(a: list, b: list, gpu: str, a_s: float, b_s: float) -> None:
    """Emit multiproc_tp's line and raise on any gate it misses."""
    from theoremsearch_tpu_torch.core.config import EncoderConfig, GemmaEncoderConfig

    layers = EncoderConfig(**MESH_TRAIN_CFG).num_layers
    g_layers = GemmaEncoderConfig().num_layers
    q = [r["tp"]["towers"]["qwen"] for r in a]
    g = [r["tp"]["towers"]["gemma"] for r in a]
    t = [x["train"] for x in q]
    sb = [r["search"] for r in b]
    tb = [r["tp"]["towers"]["qwen4"]["train"] for r in b]
    steps_a, steps_b = MP_TP_STEPS
    vs_a, vs_b = t[0]["vs_one_process"], tb[0]["vs_one_process"]

    def same(xs, *keys):
        return all(x[k] == xs[0][k] for x in xs for k in keys)

    def enc_ok(xs, counter, want):
        e = xs[0]["encode"]
        return (same([x["encode"] for x in xs], "sha256") and e["finite"]
                and e["min_cos_vs_one_process"] >= 0.9999 and e["min_cos_vs_one_device"] >= 0.999
                and all(x["encode"]["launches"][counter] == want for x in xs))

    gates = {
        "a_rows_split_over_2": all(r["tp"]["layout"] == "shard" and r["tp"]["row_group_size"] == 2
                                   and r["backend"] == "gloo" and r["device"].startswith("cuda")
                                   for r in a),
        "a_qwen_encode": enc_ok(q, "qknorm_rope_attention", layers),
        "a_gemma_encode_gathered": enc_ok(g, "qknorm_rope_attention_gemma", g_layers),
        "a_train_losses_equal_across_processes": same(t, "losses"),
        "a_train_params_bit_identical": same(t, "params_sha256"),
        "a_train_first_loss_equal_one_process": vs_a["first_loss_equal"],
        "a_train_within_limits_of_one_process": all(vs_a[k] <= lim for k, lim in MP_TRAIN_LIMITS.items()),
        "a_b2_b7_56_a_step": all(x["launches"]["qknorm_rope_attention"] == steps_a * 2 * layers
                                 and x["launches"]["qknorm_rope_attention_bwd"] == steps_a * 2 * layers
                                 for x in t),
        "a_checkpoint_bit_equal": q[0]["checkpoint"]["equal"],
        "b_rows_split_over_2": [r["tp"]["local_rows"] for r in b] == [[0], [0], [1], [1]]
                               and all(r["tp"]["column_group_size"] == 2 for r in b),
        "b_search_equal": same(sb, "ids", "scores") and all(x["equal_one_process"] for x in sb),
        "b_b1_1_a_process": all(x["launches"]["mips_g_scan"] == 1 for x in sb),
        "b_train_losses_equal_across_processes": same(tb, "losses"),
        "b_train_params_bit_identical": same(tb, "params_sha256"),
        "b_train_within_limits_of_one_process": all(vs_b[k] <= lim for k, lim in MP_TRAIN_LIMITS.items()),
        "b_b2_b7_8_a_step": all(x["launches"]["qknorm_rope_attention"] == steps_b * 2 * 4
                                and x["launches"]["qknorm_rope_attention_bwd"] == steps_b * 2 * 4
                                for x in tb),
    }
    emit("multiproc_tp", gpu=gpu, backend="gloo", seconds={"a": round(a_s, 3), "b": round(b_s, 3)},
         a={"mesh": [1, 2], "processes": 2, "layers": layers,
            "encode": {name: {"texts": xs[0]["encode"]["shape"][0],
                              "s": [x["encode"]["s"] for x in xs],
                              "min_cos_vs_one_process": xs[0]["encode"]["min_cos_vs_one_process"],
                              "min_cos_vs_one_device": xs[0]["encode"]["min_cos_vs_one_device"],
                              "equal_one_process": xs[0]["encode"]["equal_one_process"],
                              "launches": xs[0]["encode"]["launches"],
                              "collectives": xs[0]["encode"]["collectives"],
                              "peak_mem_gb": [x["encode"].get("peak_mem_gb") for x in xs]}
                       for name, xs in (("qwen", q), ("gemma", g))},
            "train_losses": t[0]["losses"], "one_process": t[0]["one_process"],
            "vs_one_process": vs_a, "equal_one_process": t[0]["equal_one_process"],
            "step_ms": [[s_ * 1e3 for s_ in x["step_s"]] for x in t],
            "collectives_a_step": _by_op(t[0]["collectives_a_step"]),
            "launches": t[0]["launches"], "peak_mem_gb": [x.get("peak_mem_gb") for x in t],
            "checkpoint": q[0]["checkpoint"],
            "part_s": [r["tp"]["part_s"] for r in a]},
         b={"mesh": [2, 2], "processes": 4, "layers": 4, "search_shape": [262_144, 1024, 1024],
            "search_launches": sb[0]["launches"], "search_collectives": sb[0]["collectives"],
            "train_losses": tb[0]["losses"], "one_process": tb[0]["one_process"],
            "vs_one_process": vs_b, "step_ms": [[s_ * 1e3 for s_ in x["step_s"]] for x in tb],
            "collectives_a_step": _by_op(tb[0]["collectives_a_step"]),
            "launches": tb[0]["launches"], "peak_mem_gb": [x.get("peak_mem_gb") for x in tb],
            "part_s": [{p: r[p]["part_s"] for p in ("search", "tp")} for r in b]},
         limits=MP_TRAIN_LIMITS, gates=gates)
    missed = [k for k, ok in gates.items() if not ok]
    if missed:
        raise AssertionError(f"multiproc_tp: gates missed: {missed}")


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
    from theoremsearch_tpu_torch.core.config import (
        BertEncoderConfig, EncoderConfig, GemmaEncoderConfig, IndexConfig,
    )
    from theoremsearch_tpu_torch.encoder import bert as bert_mod
    from theoremsearch_tpu_torch.encoder import gemma as gemma_mod
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.model import (
        _rope_tables, encode_pooled, init_params, quantize_params_int8,
    )
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer
    from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
    from theoremsearch_tpu_torch.eval.oracle import exact_topk
    from theoremsearch_tpu_torch.index import ivf as ivf_mod
    from theoremsearch_tpu_torch.index.flat import FlatIndex, l2_normalize_rows
    from theoremsearch_tpu_torch.index.ivf import IVFIndex, calibrate_nprobe
    from theoremsearch_tpu_torch.index.quant import quantize_global_int8, quantize_residual_int8
    from theoremsearch_tpu_torch.kernels import _build
    from theoremsearch_tpu_torch.kernels.attention import (
        attention_bwd_launches, attention_gemma_launches, attention_launches,
        fused_qknorm_rope_attention, fused_qknorm_rope_attention_bwd,
        fused_qknorm_rope_attention_bwd_plain, fused_qknorm_rope_attention_plain,
    )
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        attn_int8_gemma_launches, attn_int8_launches, fused_attn_int8_layer,
        fused_attn_int8_layer_gemma, fused_attn_int8_layer_gemma_plain,
        fused_attn_int8_layer_plain, fused_mlp_int8_layer, fused_mlp_int8_layer_plain,
        kernel_layout, mlp_int8_gemma_launches, mlp_int8_launches, rmsnorm_quant_plain,
    )
    from theoremsearch_tpu_torch.kernels.mips import (
        auto_merge_tiles, device_rescore, ivf_probe_scores, ivf_probe_scores_plain,
        ivf_scores_launches, mips_g_batch_order, mips_g_gmask_launches, mips_g_launches,
        mips_g_mask_launches, mips_g_scan, mips_g_scan_plain, mips_g_tile_need, mips_topk,
        mips_topk_launches, mips_topk_need, mips_topk_plain, quantize_queries, select_candidates,
    )
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.filters import compile_filter_mask
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
        "qknorm_rope_attention_bwd": attention_bwd_launches,
        "fused_attn_int8_layer": attn_int8_launches, "fused_mlp_int8_layer": mlp_int8_launches,
        "ivf_probe_scores": ivf_scores_launches,
        "qknorm_rope_attention_gemma": attention_gemma_launches,
        "fused_attn_int8_layer_gemma": attn_int8_gemma_launches,
        "fused_mlp_int8_layer_gemma": mlp_int8_gemma_launches,
    }
    main_launches = dict.fromkeys(counters, 0)

    def path_start() -> None:
        for c in counters.values():
            c.reset()

    def path_end(aside: dict | None = None) -> dict:
        """The launches since path_start, less `aside` (a check's own)."""
        got = {name: c.n - (aside or {}).get(name, 0) for name, c in counters.items()}
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
    # B=64 over the kernel's S range and the encoder's (512, 64) batches at
    # the tower's 16/8 heads; then the heads a shard of the tensor-parallel
    # phases: mesh_encode_tp's 4/2 at (512, 64) and mesh_train's 8/4 at a
    # data row's (32, 64), drawn from a generator of their own
    g_tp = torch.Generator(device=dev).manual_seed(44)
    for BB, S, H2, HK2 in ((64, 32, H, HK), (64, 64, H, HK), (64, 128, H, HK), (512, 64, H, HK),
                           (512, 64, H // 4, HK // 4), (32, 64, H // 2, HK // 2)):
        gb = g if H2 == H else g_tp
        qa = (torch.randn((BB, S, H2 * DH), generator=gb, device=dev) * 2).to(torch.bfloat16)
        ka = (torch.randn((BB, S, HK2 * DH), generator=gb, device=dev) * 2).to(torch.bfloat16)
        va = torch.randn((BB, S, HK2 * DH), generator=gb, device=dev).to(torch.bfloat16)
        qw = 1.0 + 0.1 * torch.randn((DH,), generator=gb, device=dev)
        kw = 1.0 + 0.1 * torch.randn((DH,), generator=gb, device=dev)
        lens = torch.randint(1, S + 1, (BB,), generator=gb, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        pos = torch.clamp(mask.cumsum(1) - 1, min=0).float()
        inv = 1.0 / (1e6 ** (torch.arange(0, DH, 2, device=dev).float() / DH))
        ang = pos[..., None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        kwargs = dict(num_heads=H2, num_kv_heads=HK2, head_dim=DH, eps=1e-6, causal=True)
        ok_ = fused_qknorm_rope_attention(qa, ka, va, qw, kw, cos, sin, mask, **kwargs).float()
        op = fused_qknorm_rope_attention_plain(
            qa, ka, va, qw, kw, cos, sin, mask, scale=1.0 / np.sqrt(DH), **kwargs).float()
        torch.cuda.synchronize()
        err = float((ok_ - op).abs().max())
        ref = float(op.abs().max())
        a, b = ok_.double().flatten(), op.double().flatten()
        cosv = float((a @ b) / (a.norm() * b.norm()))
        err_of["qknorm_rope_attention"] = max(err_of["qknorm_rope_attention"], err)
        emit("b2", S=S, B=BB, heads=[H2, HK2, DH], cosine=cosv, max_abs_err=err, max_abs_plain=ref)
        if not (cosv > 0.9999 and err <= 2e-2 * ref):
            raise AssertionError(f"B2 kernel disagrees with its plain version at (B, S) = ({BB}, {S}), "
                                 f"heads {H2}/{HK2}")

    # ---- 4g. B2's gemma form vs plain: head_dim 256, bidirectional ----
    GH, GHK, GDH = 3, 1, 256
    g_scale = 256.0 ** -0.5           # GemmaEncoderConfig's query_pre_attn_scalar^-1/2
    for BB, S in ((64, 32), (64, 64), (64, 128), (512, 64)):
        qa = (torch.randn((BB, S, GH * GDH), generator=g, device=dev) * 2).to(torch.bfloat16)
        ka = (torch.randn((BB, S, GHK * GDH), generator=g, device=dev) * 2).to(torch.bfloat16)
        va = torch.randn((BB, S, GHK * GDH), generator=g, device=dev).to(torch.bfloat16)
        qw = 1.0 + 0.1 * torch.randn((GDH,), generator=g, device=dev)
        kw = 1.0 + 0.1 * torch.randn((GDH,), generator=g, device=dev)
        lens = torch.randint(1, S + 1, (BB,), generator=g, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        pos = torch.clamp(mask.cumsum(1) - 1, min=0).float()
        ang = pos[..., None] * (1.0 / (1e4 ** (torch.arange(0, GDH, 2, device=dev).float() / GDH)))
        cos, sin = torch.cos(ang), torch.sin(ang)
        kwargs = dict(num_heads=GH, num_kv_heads=GHK, head_dim=GDH, eps=1e-6, causal=False,
                      scale=g_scale)
        ok_ = fused_qknorm_rope_attention(qa, ka, va, qw, kw, cos, sin, mask, **kwargs)
        op = fused_qknorm_rope_attention_plain(qa, ka, va, qw, kw, cos, sin, mask, **kwargs)
        torch.cuda.synchronize()
        cosv, err, ref = agreement(ok_.float(), op.float())
        err_of["qknorm_rope_attention_gemma"] = max(err_of["qknorm_rope_attention_gemma"], err)
        emit("b2g", S=S, B=BB, heads=[GH, GHK, GDH], cosine=cosv, max_abs_err=err, max_abs_plain=ref)
        if not (cosv > 0.9999 and err <= 2e-2 * ref):
            raise AssertionError(f"B2's gemma form disagrees with its plain version at S={S}")

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

    # ---- 4h. B3 and B4's gemma forms vs plain on one full-width gemma layer ----
    gcfg = GemmaEncoderConfig()
    glcfg = GemmaEncoderConfig(num_layers=1)
    gg = torch.Generator(device=dev).manual_seed(3)
    glayer = gemma_mod.init_params(glcfg, gg, device=dev)["layers"][0]
    for t_ in glayer.values():        # the (1 + w) norm weights off zero
        if t_.ndim == 1:
            t_ += 0.1 * torch.randn(t_.shape, generator=gg, device=dev)
    glq = kernel_layout(gemma_mod.quantize_params_int8({"layers": [glayer]}))[0]

    def check_b3b4g(kind, x, mask=None):
        """A gemma form vs its plain version: as check_b3b4, on the (1 + w)
        pre-adjusted norm weights."""
        stages = {}
        if kind == "attn":
            rope = gemma_mod._rope_tables(torch.clamp(mask.cumsum(1) - 1, min=0), GDH,
                                          glcfg.rope_local_theta)
            out = fused_attn_int8_layer_gemma(x, glayer, glq, mask, rope, glcfg, stages=stages)
            ref = fused_attn_int8_layer_gemma_plain(x, glayer, glq, mask, rope, glcfg)
            norm_w, name = 1.0 + glayer["attn_norm"], "fused_attn_int8_layer_gemma"
        else:
            norm_w, name = 1.0 + glayer["pre_mlp_norm"], "fused_mlp_int8_layer_gemma"
            args = (x, norm_w, glq["w_gate"], glq["w_up"], glq["w_down"], 1.0 + glayer["post_mlp_norm"])
            out = fused_mlp_int8_layer(*args, eps=glcfg.rms_norm_eps, act="gelu_tanh", stages=stages)
            ref = fused_mlp_int8_layer_plain(*args, eps=glcfg.rms_norm_eps, act="gelu_tanh")
        xq, sx = rmsnorm_quant_plain(x.reshape(-1, x.shape[-1]), norm_w, glcfg.rms_norm_eps)
        torch.cuda.synchronize()
        codes_equal = torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
        cosv, err, ref_max = agreement(out, ref)
        dcos, derr, dmax = agreement(out.float() - x.float(), ref.float() - x.float())
        err_of[name] = max(err_of[name], err)
        shape = list(x.shape)
        emit("b3b4g", kernel=name, shape=shape, cosine=cosv, max_abs_err=err, max_abs_plain=ref_max,
             block_cosine=dcos, block_max_abs_err=derr, block_max_abs_plain=dmax,
             codes_bit_equal=codes_equal)
        if not (cosv > 0.9999 and err <= 2e-2 * ref_max and dcos > 0.9999
                and derr <= 2e-2 * dmax and codes_equal):
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")

    gx512 = rand_x(512, 64, gcfg.hidden_size)
    check_b3b4g("attn", gx512, mask512)
    for S in (32, 128):
        lens = torch.randint(1, S + 1, (64,), generator=g, device=dev)
        check_b3b4g("attn", rand_x(64, S, gcfg.hidden_size),
                    (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32))
    for shape in ((512, 64), (64, 32), (64, 128), (70 * 128 + 70,)):
        check_b3b4g("mlp", rand_x(*shape, gcfg.hidden_size))

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
    rows_nc = torch.arange(NC, device=dev)
    biases = {"random": torch.where(torch.rand(NC, generator=gcpu) < 0.4, float("-inf"), 0.0).to(dev),
              # the serving benchmark's year filter: a contiguous 30% of the ids
              "year": torch.where((rows_nc >= int(0.4 * NC)) & (rows_nc < int(0.7 * NC)), 0.0,
                                  float("-inf"))}
    xb = unit_rows(262_144, D, 11, dev)
    corpora = {"int8_perrow_1M": (xeng.vectors, xeng.scales, True),
               "bf16_262k": (xb.to(torch.bfloat16), None, False),
               "f32_262k": (xb, None, False)}
    del xb
    cases = [(bb, k_, bf) for bb in (8, 512) for k_ in (10, 40, 400) for bf in (None, "random")]
    cases += [(64, 40, None), (512, 40, "year"), (8, 40, "year")]
    for cname, (cc, sc, exact) in corpora.items():
        qb5 = unit_rows(512, D, 12, dev)
        qk = quantize_queries(qb5)[0] if cc.dtype == torch.int8 else qb5.to(cc.dtype).contiguous()
        for bb, k_, bf in (cases if cname != "f32_262k" else [(512, 10, "random"), (8, 40, None)]):
            nv = cc.shape[0] - (1000 if bf else 0)
            bi = None if bf is None else biases[bf][: cc.shape[0]].contiguous()
            sk, ik = mips_topk(qk[:bb], cc, sc, nv, bi, k_)
            sk2, ik2 = mips_topk(qk[:bb], cc, sc, nv, bi, k_)
            sp, ip = mips_topk_plain(qk[:bb], cc, sc, nv, bi, k_)
            torch.cuda.synchronize()
            ok, err = topk_agree(sk, ik, sp, ip, exact)
            repeat = torch.equal(sk, sk2) and torch.equal(ik, ik2)
            err_of["mips_topk"] = max(err_of["mips_topk"], err)
            emit("b5", corpus=cname, batch=bb, k=k_, bias=bf, n_valid=nv, agree=ok,
                 repeat_bit_equal=repeat, max_abs_err=err)
            if not (ok and repeat):
                raise AssertionError(f"B5 kernel disagrees with its plain version ({cname}, B={bb}, k={k_})")
    del corpora

    # ---- 11. the exact route: per-row int8 index, bf16 host rescore ----
    year = f3[0]
    xq = [unit_rows(512, D, 3000 + s, dev) for s in range(5)]
    path_start()
    xres = [(xeng.search_vectors(qq, k=10)[1], xeng.search_vectors(qq, k=10, filters=year)[1]) for qq in xq]
    path3 = path_end()
    # the route's wall time a batch of 512, B5 and the host rescore included
    # (results come back to the host, so each call ends synchronized)
    exact_batch_ms = {}
    for name_, kw_ in (("unfiltered", {}), ("year", {"filters": year})):
        t0 = time.perf_counter()
        for qq in xq:
            xeng.search_vectors(qq, k=10, **kw_)
        exact_batch_ms[name_] = (time.perf_counter() - t0) * 1e3 / len(xq)
    year_mask = host_masks[0]
    xrec, xrec_f, xpass = [], [], True
    for qq, (ids_u, ids_f) in zip(xq, xres):
        xrec.append(recall_vs_exact(ids_u, exact_topk(qq, corpus_dev, k=10, device=dev)[1], k=10))
        xrec_f.append(recall_vs_exact(ids_f, exact_topk(qq, corpus_dev, k=10, device=dev,
                                                        mask=year_mask)[1], k=10))
        xpass &= bool(year_mask[ids_f[ids_f >= 0]].all())
    emit("exact", rows=NC, speed_ok=xeng._speed_ok, build_s=round(xbuild_s, 3),
         batch_ms_b512=exact_batch_ms,
         recall_draws=xrec, recall_min=min(xrec), recall_year_draws=xrec_f,
         recall_year_min=min(xrec_f), all_pass_filter=xpass, routes=dict(xeng.route_counts),
         launches=path3)
    if not (not xeng._speed_ok and min(xrec) >= 0.99 and min(xrec_f) >= 0.99 and xpass
            and path3["mips_topk"] >= 10):
        raise AssertionError("exact phase failed")

    # ---- 11r. the residual capacity mode (2 bytes/dim) ----
    def batch_wall_ms(eng_, qq, n=8, **kw_):
        """Wall ms a batch of search_vectors (results on the host)."""
        eng_.search_vectors(qq, k=10, **kw_)
        t0_ = time.perf_counter()
        for _ in range(n):
            eng_.search_vectors(qq, k=10, **kw_)
        return (time.perf_counter() - t0_) * 1e3 / n

    def profile_top(fn, name):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
        emit("profile", what=name, gpu=gpu, top_device_us=[
            [e.key[:60], round(e.self_device_time_total, 1), e.count] for e in rows])

    t0 = time.perf_counter()
    rindex = FlatIndex.build(corpus, config=IndexConfig(dtype="int8", int8_scale="global", residual=True),
                             device=dev)
    rbuild_s = time.perf_counter() - t0
    reng = SearchEngine(rindex, device=dev)      # adopts the residual codes
    path_start()
    rrec = []
    for s in range(5):
        _, ids = reng.search_vectors(qd[s], k=10)
        rrec.append(recall_vs_exact(ids, oracle[s * 1024 : (s + 1) * 1024], k=10))
    pathr = path_end()
    qpad = qd[0].contiguous()
    resid_ms = {"residual_device": cuda_ms(lambda: reng._speed_search(qpad, 10, 10), 10),
                "bf16_copy_device": cuda_ms(lambda: engine._speed_search(qpad, 10, 10), 10),
                "residual_wall": batch_wall_ms(reng, qd[0]), "bf16_copy_wall": batch_wall_ms(engine, qd[0])}
    profile_top(lambda: reng._speed_search(qpad, 10, 10), "residual_scan_rescore_b1024")
    emit("residual", rows=NC, build_s=round(rbuild_s, 3), speed_ok=reng._speed_ok,
         bytes_per_dim=(reng.vectors.numel() + reng._res_codes_device.numel()) / (NC * D),
         recall_draws=rrec, recall_min=min(rrec), batch_ms_b1024=resid_ms, gpu=gpu, launches=pathr)
    if not (reng._speed_ok and reng._rescore_device is None and min(rrec) >= 0.99
            and pathr["mips_g_scan"] >= 5):
        raise AssertionError("residual phase failed")
    del reng        # rindex serves the mesh phases too

    # the reference's capacity rung (bench.py: 6,291,456 rows at 2 bytes/dim),
    # built chunk by chunk on the card; its oracle regenerates the chunks
    NR, RCH = 6_291_456, 262_144

    def rung_chunk(i):
        return unit_rows(RCH, D, 40_000 + i, dev)

    t0 = time.perf_counter()
    amax = max(float(rung_chunk(i).abs().max()) for i in range(NR // RCH))
    rscale = amax / 127.0
    div = torch.tensor(np.float32(rscale), device=dev)
    rcodes = torch.empty((NR, D), dtype=torch.int8, device=dev)
    rres = torch.empty((NR, D), dtype=torch.int8, device=dev)
    rres_s = torch.empty(NR, dtype=torch.float32, device=dev)
    for i in range(NR // RCH):
        xc = rung_chunk(i)
        sl = slice(i * RCH, (i + 1) * RCH)
        rcodes[sl] = torch.clamp(torch.round(xc / div), -127, 127).to(torch.int8)
        rres[sl], rres_s[sl] = quantize_residual_int8(xc, rcodes[sl], rscale)
    rung = FlatIndex(vectors=rcodes, ids=torch.arange(NR, dtype=torch.int64),
                     scales=torch.full((NR,), np.float32(rscale), device=dev), num_rows=NR,
                     config=IndexConfig(dtype="int8", int8_scale="global", residual=True, dim=D),
                     global_scale=rscale, rescore_residual=(rres, rres_s))
    rung_eng = SearchEngine(rung, device=dev)
    rung_build_s = time.perf_counter() - t0
    rq = [unit_rows(1024, D, 41_000 + s, dev) for s in range(2)]
    with torch.inference_mode():
        best_s = torch.full((2048, 10), float("-inf"), device=dev)
        best_i = torch.full((2048, 10), -1, dtype=torch.int64, device=dev)
        qcat = torch.cat(rq)
        for i in range(NR // RCH):
            s_ = qcat @ rung_chunk(i).T
            cs, ci = torch.topk(s_, 10, dim=1)
            best_s, sel = torch.topk(torch.cat([best_s, cs], 1), 10, dim=1)
            best_i = torch.gather(torch.cat([best_i, ci + i * RCH], 1), 1, sel)
    rung_oracle = best_i.cpu().numpy()
    path_start()
    rung_rec = [recall_vs_exact(rung_eng.search_vectors(rq[s], k=10)[1],
                                rung_oracle[s * 1024 : (s + 1) * 1024], k=10) for s in range(2)]
    pathrr = path_end()
    rung_ms = {"device": cuda_ms(lambda: rung_eng._speed_search(rq[0], 10, 10), 5),
               "wall": batch_wall_ms(rung_eng, rq[0], n=4)}
    emit("residual_rung", rows=NR, build_s=round(rung_build_s, 3),
         device_gb=(rcodes.numel() + rres.numel() + rres_s.numel() * 4) / 1e9, recall_draws=rung_rec,
         recall_min=min(rung_rec), batch_ms_b1024=rung_ms, gpu=gpu, launches=pathrr)
    if not (rung_eng._speed_ok and min(rung_rec) >= 0.99 and pathrr["mips_g_scan"] >= 2):
        raise AssertionError("residual_rung phase failed")
    del rung_eng, rung, rcodes, rres, rres_s, best_s, best_i, qcat
    torch.cuda.empty_cache()

    # ---- 11l. live updates on phase 6's 1M index (bf16 rescore copy), B=512 ----
    lmeta = bench_metadata(NC, texts, CorpusMetadata)
    leng = SearchEngine(index, meta=lmeta, rescore_vectors=corpus, device=dev)
    xl = SearchEngine(xindex, meta=meta, rescore_vectors=rescore_bf16, device=dev)
    qlive = [qd[s][:512].contiguous() for s in range(5)]
    NA = 10_240
    add_vecs = l2_normalize_rows(unit_rows(NA, D, 50_000, dev).cpu())   # unit rows, as a build packs them
    add_meta = [{"paper_id": f"new{i}", "paper_title": f"New paper {i}",
                 "link": f"https://arxiv.org/abs/2501.{i:05d}", "year": 1995 + (i % 30),
                 "primary_category": CATS[i % len(CATS)], "journal_ref": None if i % 2 else "J. Math.",
                 "citations": i % 1000, "theorem_name": "Theorem", "slogan": f"added {i}",
                 "theorem_body": ""} for i in range(NA)]
    live_rows = torch.cat([corpus_dev, add_vecs.to(dev)])               # the oracle's rows
    alive = np.zeros(NC + NA, bool)
    alive[:NC] = True

    def live_recall(eng_, qs_, mask=None, **kw_):
        """min recall@10 over the draws vs the fp32 oracle over the live
        (and passing) rows; every returned id live (and passing)."""
        keep = alive if mask is None else alive & mask
        recs, ok = [], True
        for qq in qs_:
            _, ids_ = eng_.search_vectors(qq, k=10, **kw_)
            orc = exact_topk(qq, live_rows, k=10, device=dev, mask=keep)[1]
            recs.append(recall_vs_exact(ids_, orc, k=10))
            real = ids_[ids_ >= 0]
            ok &= bool(keep[real].all()) and bool((ids_ >= 0).all())
        return min(recs), ok

    path_start()
    base_ms = batch_wall_ms(leng, qlive[0])
    rec0, ok0 = live_recall(leng, qlive)
    t0 = time.perf_counter()
    new_ids = np.concatenate([leng.add_documents(add_vecs[i : i + 1024].numpy(), normalize=False,
                                                 meta_rows=add_meta[i : i + 1024]) for i in range(0, NA, 1024)])
    add_s = time.perf_counter() - t0
    alive[NC:] = True
    self_hits = sum(int((leng.search_vectors(add_vecs[i : i + 512].numpy(), k=1)[1][:, 0]
                         == new_ids[i : i + 512]).sum()) for i in range(0, NA, 512))
    add_ms = batch_wall_ms(leng, qlive[0])
    rec_add, ok_add = live_recall(leng, qlive)
    gdel = np.random.default_rng(60)
    del_main = gdel.choice(NC, 1000, replace=False)
    del_delta = new_ids[gdel.choice(NA, 100, replace=False)]
    deleted = np.concatenate([del_main, del_delta])
    assert leng.delete_documents(deleted) == 1100
    alive[deleted] = False
    r0 = dict(leng.route_counts)
    del_ms = batch_wall_ms(leng, qlive[0])
    rec_del, ok_del = live_recall(leng, qlive)
    overfetch_batches = leng.route_counts.get("overfetch", 0) - r0.get("overfetch", 0)
    # filtered, with tombstones and the delta: the year mix (masked) and
    # the 36-signature grouped mix; every id passes its filter and lives
    lmasks = [np.asarray(compile_filter_mask(f, leng.meta), bool) for f in f3 + f36]
    fb0, fs0 = leng.filter_mask_builds, leng.filter_mask_build_s
    rec_year, ok_year = live_recall(leng, qlive, mask=lmasks[0], filters=f3[0])
    year_builds = leng.filter_mask_builds - fb0
    year_build_ms = (leng.filter_mask_build_s - fs0) * 1e3
    sig = np.random.default_rng(61).integers(0, 36, 512)
    fb1, fs1 = leng.filter_mask_builds, leng.filter_mask_build_s
    _, gids36 = leng.search_vectors(qlive[1], k=10, filters=[f36[s_] for s_ in sig])
    g36_builds = leng.filter_mask_builds - fb1
    g36_build_ms = (leng.filter_mask_build_s - fs1) * 1e3
    g36_ok = all(bool((alive & lmasks[3 + s_])[gids36[r][gids36[r] >= 0]].all()) for r, s_ in enumerate(sig))
    year_ms = batch_wall_ms(leng, qlive[0], filters=f3[0])
    # the exact route (phase 11's per-row index) with the same main deletes:
    # unfiltered on the over-fetch, year-filtered on B5's bias form
    xl.delete_documents(del_main)
    xalive = np.ones(NC, bool)
    xalive[del_main] = False
    xrecs, xok = [], True
    for qq in qlive[:3]:
        for kw_, msk in (({}, xalive), ({"filters": year}, xalive & host_masks[0])):
            _, ids_ = xl.search_vectors(qq, k=10, **kw_)
            xrecs.append(recall_vs_exact(ids_, exact_topk(qq, corpus_dev, k=10, device=dev, mask=msk)[1], k=10))
            xok &= bool(msk[ids_[ids_ >= 0]].all())
    pathl = path_end()
    profile_top(lambda: leng.search_vectors(qlive[0], k=10), "live_batch_b512_delta_tombstones")
    # the three B1 forms and B5's bias form at the live inputs, vs plain
    q8l, qsl = quantize_queries(qlive[0])
    ml = auto_merge_tiles(D, leng.row_block // 128, leng.padded_rows // leng.row_block)
    tomb_dev = leng._combined_mask_inputs(None)[1]
    year_tomb_dev = leng._combined_mask_inputs(f3[0])[1]
    st_live = torch.stack([leng._combined_mask_inputs(f)[1] for f in f36[:32]])
    mid_live = torch.from_numpy(sig % 32).to(dev, torch.int32)
    b1_live = {}
    for name_, key_, kw_ in (("none", "mips_g_scan", {}), ("tombstones", "mips_g_scan_mask", {"mask": tomb_dev}),
                             ("year_and_tombstones", "mips_g_scan_mask", {"mask": year_tomb_dev}),
                             ("gmask_32_tombstones", "mips_g_scan_gmask",
                              {"gmasks": st_live, "mask_ids": mid_live})):
        b1_live[name_], _, _ = check_b1(key_, leng.n_valid, ml, q8l, qsl, leng._global_scale, leng.vectors,
                                        leng.row_block, **kw_)
    xbias = xl._combined_mask_inputs(year)[1]
    qx8 = quantize_queries(qlive[0])[0]
    sk, ik = mips_topk(qx8, xl.vectors, xl.scales, NC, xbias, 40)
    sp, ip = mips_topk_plain(qx8, xl.vectors, xl.scales, NC, xbias, 40)
    b5_live, b5_err = topk_agree(sk, ik, sp, ip, True)
    err_of["mips_topk"] = max(err_of["mips_topk"], b5_err)
    emit("live", rows=NC, batch=512, added=NA, add_s=round(add_s, 3), added_self_top1=self_hits,
         deleted_main=1000, deleted_delta=100, batch_ms={"baseline": base_ms, "after_add": add_ms,
         "after_delete": del_ms, "year_filtered": year_ms},
         tombstone_overhead=del_ms / add_ms, overfetch_batches=overfetch_batches,
         recall_min={"baseline": rec0, "after_add": rec_add, "after_delete": rec_del, "year": rec_year},
         no_deleted_returned=ok0 and ok_add and ok_del and ok_year and g36_ok,
         mask_builds={"year": year_builds, "grouped36": g36_builds},
         mask_build_ms={"year": year_build_ms, "grouped36": g36_build_ms},
         exact_route={"recall_min": min(xrecs), "all_live_and_passing": xok, "routes": dict(xl.route_counts)},
         kernels_bit_equal={**b1_live, "mips_topk_bias": b5_live}, routes=dict(leng.route_counts),
         num_live=leng.num_live, gpu=gpu, launches=pathl)
    if not (self_hits == NA and min(rec0, rec_add, rec_del, rec_year, min(xrecs)) >= 0.99
            and ok0 and ok_add and ok_del and ok_year and g36_ok and xok and all(b1_live.values())
            and b5_live and leng.num_live == NC + NA - 1100
            and all(pathl[k_] >= 1 for k_ in ("mips_g_scan", "mips_g_scan_mask", "mips_g_scan_gmask",
                                               "mips_topk"))):
        raise AssertionError("live phase failed")

    # ---- 11c. compact and reclaim while a client queries ----
    def compact_under_load(reclaim):
        lat, stop_ = [], threading.Event()
        qc = qlive[2][:64].contiguous()

        def client():
            while not stop_.is_set():
                t_ = time.perf_counter()
                leng.search_vectors(qc, k=10)
                lat.append((t_, time.perf_counter() - t_))

        base = [batch_wall_ms(leng, qc, n=20)]
        th = threading.Thread(target=client)
        th.start()
        time.sleep(0.5)
        t_c = time.perf_counter()
        folded_ = leng.compact(reclaim=reclaim)
        t_e = time.perf_counter()
        time.sleep(0.2)
        stop_.set()
        th.join()
        during = [(t_ - t_c, d_) for t_, d_ in lat if t_ + d_ >= t_c and t_ <= t_e]
        slow = sorted(during, key=lambda x_: -x_[1])[:5]
        return {"folded": folded_, "seconds": t_e - t_c, "queries_during": len(during),
                "longest_query_ms": 1e3 * max((d_ for _, d_ in during), default=0.0),
                "slowest_at_s_ms": [[round(a_, 3), round(1e3 * d_, 1)] for a_, d_ in slow],
                "idle_query_ms": base[0],
                "rows_after": leng.n_valid, "num_live_after": leng.num_live,
                "stats": {k_: (round(v_, 4) if isinstance(v_, float) else v_)
                          for k_, v_ in (leng.last_compact_stats or {}).items()}}

    path_start()
    comp = compact_under_load(False)
    n_fold = leng.n_valid
    rec_c, ok_c = live_recall(leng, qlive)
    # the fold's codes against a fresh FlatIndex.build of the same rows
    # (phase 6's normalized rows, the added rows, zeros at the deleted
    # delta rows' ids, which fold as tombstoned gaps)
    fold_rows = torch.cat([l2_normalize_rows(torch.from_numpy(corpus), dev), add_vecs])
    fold_rows[torch.from_numpy(del_delta)] = 0
    fresh = FlatIndex.build(fold_rows, config=IndexConfig(dtype="int8", int8_scale="global"),
                            normalize=False, device=dev)
    same_scale = fresh.global_scale == leng._global_scale
    fold_equal = (same_scale and torch.equal(fresh.vectors[:n_fold], leng.index.vectors[:n_fold])
                  and torch.equal(fresh.vectors[:n_fold].to(dev), leng.vectors[:n_fold]))
    fold_dev = live_rows.clone()
    fold_dev[torch.from_numpy(del_delta).to(dev)] = 0
    rescore_equal = all(torch.equal(leng._rescore_device[i : i + 131_072],
                                    fold_dev[i : i + 131_072].to(torch.bfloat16))
                        for i in range(0, n_fold, 131_072))
    del fold_rows, fresh, fold_dev
    inflight = leng.search_vectors_async(qlive[3], k=10)          # dispatched before the swap
    recl = compact_under_load(True)
    _, inflight_ids = inflight()
    id_map = leng.last_id_map
    keep_old = np.nonzero(id_map >= 0)[0]
    rows_new = live_rows[torch.from_numpy(keep_old).to(dev)]
    orc_new = exact_topk(qlive[3], rows_new, k=10, device=dev)[1]
    inflight_rec = recall_vs_exact(inflight_ids, orc_new, k=10)
    _, after_ids = leng.search_vectors(qlive[3], k=10)
    inflight_equal = float((inflight_ids == after_ids).mean())
    rrecs = []
    for qq in qlive:
        _, ids_ = leng.search_vectors(qq, k=10)
        rrecs.append(recall_vs_exact(ids_, exact_topk(qq, rows_new, k=10, device=dev)[1], k=10))
    pathc = path_end()
    emit("compact", compact=comp, reclaim=recl, recall_min_after_compact=rec_c,
         recall_min_after_reclaim=min(rrecs), no_deleted_after_compact=ok_c,
         fold_bit_equal_fresh_build=fold_equal, fold_same_global_scale=same_scale,
         rescore_copy_bit_equal=rescore_equal, inflight_recall=inflight_rec,
         inflight_ids_equal_post_swap=inflight_equal, generation=leng._generation,
         rows_after_reclaim=leng.n_valid, gpu=gpu, launches=pathc)
    if not (comp["folded"] == NA - 100 and recl["rows_after"] == NC + NA - 1100 and rec_c >= 0.99 and ok_c
            and min(rrecs) >= 0.99 and fold_equal and rescore_equal and inflight_rec >= 0.99
            and inflight_equal >= 0.99 and leng._tombstone is None and leng._speed_ok):
        raise AssertionError("compact phase failed")

    # ---- 11s. live routes over HTTP: add slogans, find them, delete them ----
    lsched = BatchScheduler(leng, max_batch=64, encode_fn=encoder.encode_device)
    lservice = SearchService(leng, encoder.encode, scheduler=lsched)
    lserver = SearchServer(lservice, "127.0.0.1", 0).start()
    new_texts = slogans(4096 + 32)[4096:]

    def lpost(path_, body):
        req = urllib.request.Request(f"http://127.0.0.1:{lserver.port}{path_}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        path_start()
        code_add, added = lpost("/documents", {"documents": [
            {"slogan": t_, "theorem_name": "Theorem", "link": "https://arxiv.org/abs/2502.00001",
             "year": 2024, "paper_title": "Live"} for t_ in new_texts]})
        with ThreadPoolExecutor(8) as ex:
            found = list(ex.map(lambda t_: lpost("/search", {"query": t_, "top_k": 10}), new_texts))
        code_del, deleted_ = lpost("/documents/delete", {"doc_ids": added["doc_ids"]})
        with ThreadPoolExecutor(8) as ex:
            after = list(ex.map(lambda t_: lpost("/search", {"query": t_, "top_k": 10}), new_texts))
        paths = path_end()
    finally:
        lserver.stop()
        lsched.shutdown()
    ids_new = added["doc_ids"]
    found_ok = [d_ in [r["doc_id"] for r in body["results"]] for d_, (_, body) in zip(ids_new, found)]
    gone = all(not set(ids_new) & {r["doc_id"] for r in body["results"]} for _, body in after)
    all200 = code_add == code_del == 200 and all(c_ == 200 for c_, _ in found + after)
    emit("serve_live", added=len(ids_new), all_200=all200, found_by_text=sum(found_ok),
         found_top1=sum(d_ == body["results"][0]["doc_id"] for d_, (_, body) in zip(ids_new, found)),
         deleted=deleted_["deleted"], deleted_absent=gone, gpu=gpu, launches=paths)
    if not (all200 and all(found_ok) and gone and deleted_["deleted"] == len(new_texts)
            and paths["qknorm_rope_attention"] >= 1 and paths["mips_g_scan"] >= 1):
        raise AssertionError("serve_live phase failed")
    del leng, xl, lmeta, live_rows, rows_new, lservice, lsched, inflight
    torch.cuda.empty_cache()

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

    # ---- 16l. live updates on the IVF route: adds, deletes, compact, reclaim ----
    ieng = SearchEngine(flat_ivf, rescore_vectors=ivf_corpus, device=dev, ivf_index=ivf)
    NAI = 1024
    gi = torch.Generator(device=dev).manual_seed(70)
    iadd = centres[torch.randint(0, NL, (NAI,), generator=gi, device=dev)] + (
        1.5 / np.sqrt(D)) * torch.randn((NAI, D), generator=gi, device=dev)
    iadd = (iadd / iadd.norm(dim=1, keepdim=True)).cpu()
    irows = torch.cat([ivf_dev, iadd.to(dev)])                          # the oracle's rows, old ids
    ialive = np.zeros(NI + NAI, bool)
    ialive[:NI] = True

    def ivf_live_recall(id_of_row=None):
        """min recall@10 at B=8 over phase 15's 5 draws vs the fp32 oracle
        over the live rows; every id live. id_of_row: old row -> present
        id (after a reclaim)."""
        recs, ok = [], True
        for qq, _ in draws:
            got = np.concatenate([ieng.search_vectors(qq[j : j + 8], k=10)[1] for j in range(0, 128, 8)])
            orc = exact_topk(qq, irows, k=10, device=dev, mask=ialive)[1]
            if id_of_row is not None:
                orc = np.where(orc >= 0, id_of_row[np.clip(orc, 0, None)], -1)
                live_ids = id_of_row[ialive]
            else:
                live_ids = np.nonzero(ialive)[0]
            recs.append(recall_vs_exact(got, orc, k=10))
            ok &= bool(np.isin(got, live_ids).all())
        return min(recs), ok

    path_start()
    r_ivf0 = ieng.route_counts.get("ivf", 0)
    iids = ieng.add_documents(iadd.numpy(), normalize=False)
    ialive[NI:] = True
    gdi = np.random.default_rng(71)
    idel = np.concatenate([gdi.choice(NI, 1000, replace=False), iids[gdi.choice(NAI, 24, replace=False)]])
    assert ieng.delete_documents(idel) == 1024
    ialive[idel] = False
    irec_live, iok_live = ivf_live_recall()
    t0 = time.perf_counter()
    assert ieng.compact() == NAI - 24
    icompact_s = time.perf_counter() - t0
    icompact_stats = dict(ieng.last_compact_stats)
    irec_c, iok_c = ivf_live_recall()
    t0 = time.perf_counter()
    ieng.compact(reclaim=True)
    ireclaim_s = time.perf_counter() - t0
    ireclaim_stats = dict(ieng.last_compact_stats)
    irec_r, iok_r = ivf_live_recall(id_of_row=ieng.last_id_map)
    pathi = path_end()
    ivf_batches_live = ieng.route_counts.get("ivf", 0) - r_ivf0
    # B6 on the updated slabs against its plain version, at a B=8 search's chunks
    ipa = ieng.ivf._device_arrays()
    qb8 = draws[0][0][:8].contiguous()
    with torch.no_grad():
        probe = torch.topk(qb8 @ ipa["cents"].T, ieng.ivf_nprobe, dim=1).indices
    nl_ = ieng.ivf.slabs.shape[0]
    uids_live = ivf_mod.unique_fixed(
        torch.cat([probe.reshape(-1), torch.arange(nl_, nl_ + ipa["n_spill_chunks"], device=dev)]),
        min(8 * ieng.ivf_nprobe, nl_) + ipa["n_spill_chunks"], ipa["slabs"].shape[0] - 1).to(torch.int32)
    ck, cqs = ivf_probe_scores(qb8, ipa["slabs"], uids_live)
    cp, cps = ivf_probe_scores_plain(qb8, ipa["slabs"], uids_live)
    b6_live = torch.equal(ck, cp) and torch.equal(cqs, cps)
    err_of["ivf_probe_scores"] = max(err_of["ivf_probe_scores"], int((ck.long() - cp.long()).abs().max()))
    emit("ivf_live", added=NAI, deleted=1024, nprobe=ieng.ivf_nprobe,
         recall_b8_min={"live": irec_live, "after_compact": irec_c, "after_reclaim": irec_r},
         no_deleted_returned=iok_live and iok_c and iok_r, ivf_route_batches=ivf_batches_live,
         ivf_rows=ieng.ivf.num_rows, spill_rows=int((ieng.ivf.spill_ids >= 0).sum()),
         compact_s=round(icompact_s, 3), reclaim_s=round(ireclaim_s, 3),
         compact_stats={k_: (round(v_, 4) if isinstance(v_, float) else v_) for k_, v_ in icompact_stats.items()},
         reclaim_stats={k_: (round(v_, 4) if isinstance(v_, float) else v_) for k_, v_ in ireclaim_stats.items()},
         b6_bit_equal_updated_slabs=b6_live, gpu=gpu, launches=pathi)
    if not (min(irec_live, irec_c, irec_r) >= 0.99 and iok_live and iok_c and iok_r and b6_live
            and ieng.ivf is not None and ivf_batches_live >= 3 * 80 and ieng.n_valid == NI + NAI - 1024
            and pathi["ivf_probe_scores"] >= 1):
        raise AssertionError("ivf_live phase failed")
    del ieng, irows, ipa
    torch.cuda.empty_cache()

    # ---- 16m. the serving paths on a mesh of four shards on the card ----
    mesh_phases(dev, gpu, counters, path_start, path_end, index=index, rindex=rindex, corpus=corpus,
                corpus_dev=corpus_dev, qd=qd, oracle=oracle, meta=meta, f3=f3, f36=f36,
                host_masks=host_masks, xindex=xindex, rescore_bf16=rescore_bf16, engine=engine,
                xeng=xeng, ivf=ivf, ivf_corpus=ivf_corpus, flat_ivf=flat_ivf, draws=draws,
                nprobe=int(np_cal), params=params, cfg=cfg, encoder=encoder, encoder8=encoder8,
                texts=texts, serve_round=serve_round)
    del rindex
    torch.cuda.empty_cache()

    # ---- 16t. tensor-parallel encoding of the three towers ----
    mesh_encode_tp(dev, gpu, counters, path_start, path_end, texts=texts)

    # ---- 20. the gemma tower at full width (embeddinggemma-300m class) ----
    gparams = gemma_mod.init_params(gcfg, torch.Generator(device=dev).manual_seed(31), device=dev)
    gnorm = torch.Generator(device=dev).manual_seed(32)
    for layer_ in gparams["layers"]:   # the (1 + w) norm weights off zero
        for t_ in layer_.values():
            if t_.ndim == 1:
                t_ += 0.1 * torch.randn(t_.shape, generator=gnorm, device=dev)
    g_n_params = sum(t_.numel() for t_ in gparams.values() if isinstance(t_, torch.Tensor)) + sum(
        t_.numel() for layer_ in gparams["layers"] for t_ in layer_.values())
    genc = BatchedEncoder(gparams, gcfg, batch_size=512, device=dev)
    genc8 = BatchedEncoder(gparams, gcfg, batch_size=512, device=dev, quant="int8")
    gql = genc8.qlayers
    gim, _ = genc._prep_batch(texts[:512], [genc.tokenizer.tokenize(t_) for t_ in texts[:512]],
                              list(range(512)))
    gt = torch.from_numpy(gim).to(dev)
    with torch.inference_mode():
        gk = gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, fused="on")
        gp = gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, fused="plain")
        go = gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, fused="off")
        g8k = gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, qlayers=gql, fused_layers=True)
        g8p = gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, fused="plain", qlayers=gql,
                                      fused_layers=True)
    path_start()
    t0 = time.perf_counter()
    g_emb = genc.encode(texts)
    genc_s = time.perf_counter() - t0
    path_g = path_end()
    gcos = float((gk.double() * gp.double()).sum(1).min())
    emit("encoder_gemma", params=g_n_params, layers=gcfg.num_layers, hidden=gcfg.hidden_size,
         heads=[gcfg.num_heads, gcfg.num_kv_heads, gcfg.head_dim], width=int(gt.shape[2]),
         encode_4096_s=round(genc_s, 3), cos_kernel_vs_plain_min=gcos,
         cos_kernel_vs_reference_composition_min=float((gk.double() * go.double()).sum(1).min()),
         slogan_emb_mean_pairwise_cos=float(np.mean(g_emb[:256] @ g_emb[:256].T)),
         finite=bool(np.isfinite(g_emb).all()), launches=path_g)
    if not (gcos > 0.9999 and path_g["qknorm_rope_attention_gemma"] >= gcfg.num_layers
            and np.isfinite(g_emb).all() and g_emb.shape == (4096, gcfg.embedding_dim)):
        raise AssertionError("encoder_gemma phase failed")
    path_start()
    t0 = time.perf_counter()
    g_emb8 = genc8.encode(texts)
    genc8_s = time.perf_counter() - t0
    path_g8 = path_end()
    gcos8 = float((g8k.double() * g8p.double()).sum(1).min())
    g8_vs_bf16 = float((g8k.double() * gk.double()).sum(1).min())
    emit("encoder_gemma_int8", encode_4096_s=round(genc8_s, 3), cos_kernel_vs_plain_min=gcos8,
         cos_int8_vs_bf16_kernel_min=g8_vs_bf16,
         cos_slogans_int8_vs_bf16_min=float(np.min(np.sum(g_emb8 * g_emb, axis=1))),
         finite=bool(np.isfinite(g_emb8).all()), launches=path_g8)
    if not (gcos8 > 0.999 and g8_vs_bf16 > 0.98 and np.isfinite(g_emb8).all()
            and min(path_g8["fused_attn_int8_layer_gemma"], path_g8["fused_mlp_int8_layer_gemma"])
            >= gcfg.num_layers):
        raise AssertionError("encoder_gemma_int8 phase failed")

    # ---- 21. gemma serving: 1M x 768 int8-global index, scheduler, HTTP ----
    NG, DG = NC, gcfg.embedding_dim
    t0 = time.perf_counter()
    gcorpus = np.empty((NG, DG), np.float32)
    for i in range(0, NG, 131_072):
        gcorpus[i : i + 131_072] = unit_rows(131_072, DG, 60 + i // 131_072, dev).cpu().numpy()
    gcorpus[:4096] = g_emb
    gindex = FlatIndex.build(gcorpus, config=IndexConfig(dtype="int8", int8_scale="global"), device=dev)
    geng = SearchEngine(gindex, meta=meta, rescore_vectors=gcorpus, device=dev)
    gbuild_s = time.perf_counter() - t0
    g_rb = geng.row_block
    g_m = auto_merge_tiles(DG, g_rb // 128, geng.padded_rows // g_rb)
    gq8, gqs = quantize_queries(unit_rows(1024, DG, 4000, dev))
    ok, err, shape = check_b1("mips_g_scan", geng.n_valid, g_m, gq8, gqs, geng._global_scale,
                              geng.vectors, g_rb)
    emit("b1", index="1M x 768", n_valid=geng.n_valid, merge_tiles=g_m, shape=shape, bit_equal=ok,
         max_abs_err=err, build_s=round(gbuild_s, 3), speed_ok=geng._speed_ok)
    if not (ok and geng._speed_ok):
        raise AssertionError("B1 at D = 768 disagrees with its plain version (or no speed path)")
    gtexts = [texts[(41 * i) % 4096] for i in range(128)]
    for mode, enc_ in (("bf16", genc), ("int8", genc8)):
        gsched = BatchScheduler(geng, max_batch=256, encode_fn=enc_.encode_device)
        gservice = SearchService(geng, enc_.encode, scheduler=gsched)
        gdirect = SearchService(geng, enc_.encode)
        path_start()
        ganswers, gserve_s, gstats, gwarm = serve_round(gservice, [{"query": t_, "top_k": 10}
                                                                   for t_ in gtexts])
        path_gs = path_end()
        gcodes = all(code == 200 for code, _ in ganswers)
        gover, gself = [], 0
        for text, (_, body) in zip(gtexts, ganswers):
            got = [r["doc_id"] for r in body["results"]]
            want = [r["doc_id"] for r in gdirect.search_and_display(text)]
            gover.append(len(set(got) & set(want)) / 10)
            gself += texts.index(text) == got[0]
        gb = gstats["batches"] - gwarm["batches"]
        emit("serve_gemma", mode=mode, requests=len(ganswers), all_200=gcodes,
             overlap10_mean=float(np.mean(gover)), overlap10_min=float(np.min(gover)),
             self_top1=gself, wall_s=round(gserve_s, 3), batches=gb,
             avg_batch=(gstats["queries"] - gwarm["queries"]) / max(gb, 1),
             latency_ms=gstats.get("latency_ms"), stages_ms={
                 k: v for k, v in gstats.get("stages_ms", {}).items() if k != "worst_batches"},
             launches=path_gs)
        need = (["qknorm_rope_attention_gemma"] if mode == "bf16"
                else ["fused_attn_int8_layer_gemma", "fused_mlp_int8_layer_gemma"])
        if not (gcodes and np.mean(gover) >= 0.9 and len(ganswers) == 128
                and path_gs["mips_g_scan"] >= 1 and min(path_gs[n_] for n_ in need) >= 1):
            raise AssertionError(f"serve_gemma ({mode}) phase failed")

    # ---- 22. the BERT tower at full width (no kernel) ----
    bcfg = BertEncoderConfig()
    bparams = bert_mod.init_params(bcfg, torch.Generator(device=dev).manual_seed(41), device=dev)
    benc = BatchedEncoder(bparams, bcfg, batch_size=512, device=dev)
    t0 = time.perf_counter()
    b_emb = benc.encode(texts)
    benc_s = time.perf_counter() - t0
    bim, _ = benc._prep_batch(texts[:512], [benc.tokenizer.tokenize(t_) for t_ in texts[:512]],
                              list(range(512)))
    bt = torch.from_numpy(bim).to(dev)
    with torch.inference_mode():
        bert_ms = cuda_ms(lambda: bert_mod.encode_pooled(bparams, bt[0], bt[1], bcfg), 5)
        bcard = bert_mod.encode_pooled(bparams, bt[0][:8], bt[1][:8], bcfg).double().cpu()
        bparams_cpu = {k_: ([{n_: t_.cpu() for n_, t_ in l_.items()} for l_ in v_]
                            if k_ == "layers" else v_.cpu()) for k_, v_ in bparams.items()}
        bcpu = bert_mod.encode_pooled(bparams_cpu, bt[0][:8].cpu(), bt[1][:8].cpu(), bcfg).double()
    b_cos = float((bcard * bcpu).sum(1).min())
    emit("bert", layers=bcfg.num_layers, hidden=bcfg.hidden_size, width=int(bt.shape[2]),
         encode_4096_s=round(benc_s, 3), forward_ms_512x64=bert_ms, cos_card_vs_cpu_min=b_cos,
         finite=bool(np.isfinite(b_emb).all()))
    if not (b_cos > 0.999 and np.isfinite(b_emb).all() and b_emb.shape == (4096, bcfg.embedding_dim)):
        raise AssertionError("bert phase failed")
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_b:
        bert_mod.encode_pooled(bparams, bt[0], bt[1], bcfg)
        torch.cuda.synchronize()
    emit("profile", what="bert_forward_512x64", gpu=gpu, top_device_us=[
        [e.key[:60], round(e.self_device_time_total, 1), e.count]
        for e in sorted(prof_b.key_averages(), key=lambda e: -e.self_device_time_total)[:10]])
    del bparams, bparams_cpu, benc, prof_b

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
    # library yardstick: the same int8 product alone through torch._int_mm
    # (cuBLAS; the port never calls it), in 16,384-row slices of the corpus
    slices = [engine.vectors[r0 : r0 + 16384].t() for r0 in range(0, nrows, 16384)]

    def int_mm_scan():
        for w_ in slices:
            torch._int_mm(q8, w_)

    times["mips_g_scan"]["library_ms"] = cuda_ms(int_mm_scan, 5)
    del slices
    # the unmasked form at the served batch buckets, where each span is
    # split across blocks (atomicMax into a prefilled output): bit-equal
    # to plain there first, then device and back-to-back wrapper times
    b1_small = {}
    for bs in (8, 64):
        q8s = q8[:bs].contiguous()

        def small():
            return mips_g_scan(q8s, engine.vectors, n_valid, rb, m)

        if not torch.equal(small(), mips_g_scan_plain(q8s, engine.vectors, n_valid, rb, m)):
            raise AssertionError(f"B1 at B={bs} on the 1M index disagrees with plain")
        b1_small[f"B{bs}"] = {"ms": queued_ms(small, 20), "wrapper_ms": cuda_ms(small, 20),
                              **bound(nrows * D + bs * D + bs * out_bytes // 1024,
                                      {"int8": 2 * bs * n_valid * D})}
    # masked forms: only the passing rows' products and codes are needed
    n_year = int(host_masks[0].sum())
    timed("mips_g_scan_mask", lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m, mask=year_dev),
          lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m, mask=year_dev),
          nrows + n_year * D + 1024 * D + out_bytes, {"int8": 2 * 1024 * n_year * D})
    st32, g32 = st36[:32].contiguous(), torch.randint(0, 32, (1024,), generator=gcpu, dtype=torch.int32)
    pass_of = np.array([int(mk.sum()) for mk in host_masks[3:35]])
    n_union = int(np.logical_or.reduce(host_masks[3:35]).sum())
    g32 = g32.to(dev)
    for name_, kw_ in (("mask", {"mask": year_dev}), ("gmask", {"gmasks": st32, "mask_ids": g32[:8]})):
        if not torch.equal(mips_g_scan(q8[:8], engine.vectors, n_valid, rb, m, **kw_),
                           mips_g_scan_plain(q8[:8], engine.vectors, n_valid, rb, m, **kw_)):
            raise AssertionError(f"B1's {name_} form at B=8 on the 1M index disagrees with plain")
    timed("mips_g_scan_gmask",
          lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m, gmasks=st32, mask_ids=g32),
          lambda: mips_g_scan_plain(q8, engine.vectors, n_valid, rb, m, gmasks=st32, mask_ids=g32),
          32 * nrows + n_union * D + 1024 * (D + 4) + out_bytes,
          {"int8": 2 * int(pass_of[g32.cpu().numpy()].sum()) * D})
    # B1's "ms" is the wrapper's back-to-back time; its device time, the
    # launches queued behind a sleep (the masked wrappers' host work, the
    # need map and the grouped form's batch order, then overlaps nothing),
    # stands beside it
    b1_device_ms = {}
    for name_, kw_ in (("mips_g_scan", {}), ("mips_g_scan_mask", {"mask": year_dev}),
                       ("mips_g_scan_gmask", {"gmasks": st32, "mask_ids": g32})):
        b1_device_ms[name_] = queued_ms(lambda: mips_g_scan(q8, engine.vectors, n_valid, rb, m, **kw_), 10)
    # the share of (query tile, 128-row group) pairs the grouped scan computes
    # (the rest are skipped: no row passes any signature of the tile)
    gperm = mips_g_batch_order(g32)
    gneed_share = float(mips_g_tile_need(nrows, gmasks=st32, mask_ids=g32[gperm]).float().mean())
    qx = quantize_queries(unit_rows(512, D, 14, dev))[0]
    timed("mips_topk", lambda: mips_topk(qx, xeng.vectors, xeng.scales, NC, None, 40),
          lambda: mips_topk_plain(qx, xeng.vectors, xeng.scales, NC, None, 40),
          NC * (D + 4) + 512 * D + 512 * 40 * 8, {"int8": 2 * 512 * NC * D}, plain_iters=2)
    qbf = unit_rows(512, D, 15, dev).to(torch.bfloat16)
    bf_corpus = engine._rescore_device
    timed("mips_topk_bf16", lambda: mips_topk(qbf, bf_corpus, None, NC, None, 40),
          lambda: mips_topk_plain(qbf, bf_corpus, None, NC, None, 40),
          NC * D * 2 + 512 * D * 2 + 512 * 40 * 8, {"bf16": 2 * 512 * NC * D}, plain_iters=2)
    # library yardsticks for B5's products alone (the port never calls
    # them): torch._int_mm / torch.matmul over the same product in
    # 16,384-row slices of the corpus
    i8_slices = [xeng.vectors[r0 : r0 + 16384].t() for r0 in range(0, NC, 16384)]
    bf_slices = [bf_corpus[r0 : r0 + 16384].t() for r0 in range(0, NC, 16384)]

    def int_mm_b5():
        for w_ in i8_slices:
            torch._int_mm(qx, w_)

    def matmul_b5():
        for w_ in bf_slices:
            torch.matmul(qbf, w_)

    times["mips_topk"]["library_ms"] = cuda_ms(int_mm_b5, 5)
    times["mips_topk_bf16"]["library_ms"] = cuda_ms(matmul_b5, 5)
    del i8_slices, bf_slices
    # B5 on the exact route's 1M per-row index beyond B = 512, k = 40: B = 8
    # and 64 (held bit-equal to plain there first), the serving benchmark's
    # year filter as a 0 / -inf bias (a contiguous 30% of the ids; only the
    # groups with a passing row are computed) and k = 400; each as device
    # time (launches queued behind a sleep kernel) and back to back
    year_bias = biases["year"]
    year_groups = int(mips_topk_need(year_bias, NC).sum())
    b5_more = {}
    for name_, bb, k_, bi in (("B8", 8, 40, None), ("B64", 64, 40, None),
                               ("year_B512", 512, 40, year_bias), ("k400_B512", 512, 400, None)):
        qs_ = qx[:bb].contiguous()

        def exact_scan(qs_=qs_, k_=k_, bi=bi):
            return mips_topk(qs_, xeng.vectors, xeng.scales, NC, bi, k_)

        if bb < 512:
            sk, ik = exact_scan()
            if not topk_agree(sk, ik, *mips_topk_plain(qs_, xeng.vectors, xeng.scales, NC, bi, k_),
                              True)[0]:
                raise AssertionError(f"B5 at B={bb} on the 1M index disagrees with plain")
        rows_ = NC if bi is None else year_groups * 128
        b5_more[name_] = {"ms": queued_ms(exact_scan, 10), "wrapper_ms": cuda_ms(exact_scan, 10),
                          **bound(rows_ * (D + 4 + (0 if bi is None else 4)) + bb * D + bb * k_ * 8,
                                  {"int8": 2 * bb * rows_ * D})}
    b5_more["year_B512"]["computed_group_share"] = year_groups / (NC // 128)
    b5_device_ms = {
        "mips_topk": queued_ms(lambda: mips_topk(qx, xeng.vectors, xeng.scales, NC, None, 40), 10),
        "mips_topk_bf16": queued_ms(lambda: mips_topk(qbf, bf_corpus, None, NC, None, 40), 10)}

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

    def int8_products(fn, t_, products, key):
        """The int8 products of one B3 / B4 call: the port's own product
        kernel (i8_gemm_kernel's device time in a profile of one call)
        beside torch._int_mm (cuBLAS's int8 path, never called by the
        port) on the same (T, K) x (K, N) shapes, summed; the latter is the
        kernel line's library_ms for the products alone."""
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        own = sum(e.self_device_time_total for e in prof_.key_averages()
                  if "i8_gemm_kernel" in e.key) / 1e3
        lib = 0.0
        for k_, n_ in products:
            a_ = torch.randint(-127, 128, (t_, k_), generator=g, device=dev, dtype=torch.int8)
            w_ = torch.randint(-127, 128, (n_, k_), generator=g, device=dev, dtype=torch.int8)
            lib += cuda_ms(lambda: torch._int_mm(a_, w_.t()), 10)
        times[key]["library_ms"] = lib
        int8_product_ms[key] = {"kernel_products_ms": own, "int_mm_ms": lib,
                                "products": [[t_, k_, n_] for k_, n_ in products]}

    int8_product_ms = {}
    int8_products(lambda: fused_attn_int8_layer(x512, layer, lq, mask512, rope512, lcfg), T,
                  [(DM, HQ), (DM, HKD), (DM, HKD), (HQ, DM)], "fused_attn_int8_layer")
    int8_products(lambda: fused_mlp_int8_layer(x512, layer["mlp_norm"], lq["w_gate"], lq["w_up"],
                                               lq["w_down"]), T,
                  [(DM, I), (DM, I), (I, DM)], "fused_mlp_int8_layer")
    # the gemma forms at (512, 64) on the slogans' masks: B2 bidirectional
    # (every pair of live tokens), B3 and B4 on the phase-4h layer
    GS = int(gt.shape[2])
    gmsk = gt[1].to(torch.int32).contiguous()
    gqa = torch.randn((512, GS, GH * GDH), generator=g, device=dev).to(torch.bfloat16)
    gka = torch.randn((512, GS, GHK * GDH), generator=g, device=dev).to(torch.bfloat16)
    gva = torch.randn((512, GS, GHK * GDH), generator=g, device=dev).to(torch.bfloat16)
    gcs = torch.randn((512, GS, GDH // 2), generator=g, device=dev)
    gsn = torch.randn((512, GS, GDH // 2), generator=g, device=dev)
    gw1 = torch.ones(GDH, device=dev)
    gkw = dict(num_heads=GH, num_kv_heads=GHK, head_dim=GDH, eps=1e-6, causal=False, scale=g_scale)
    glive = gmsk.sum(1).double()
    timed("qknorm_rope_attention_gemma",
          lambda: fused_qknorm_rope_attention(gqa, gka, gva, gw1, gw1, gcs, gsn, gmsk, **gkw),
          lambda: fused_qknorm_rope_attention_plain(gqa, gka, gva, gw1, gw1, gcs, gsn, gmsk, **gkw),
          gqa.numel() * 2 * 2 + gka.numel() * 2 * 2 + gcs.numel() * 4 * 2 + gmsk.numel() * 4
          + GDH * 4 * 2, {"bf16": float(4 * GH * GDH * (glive * glive).sum())}, plain_iters=5)
    GT, GD, GI = gx512.shape[0] * gx512.shape[1], gcfg.hidden_size, gcfg.intermediate_size
    GHQ, GHKD = GH * GDH, GHK * GDH
    grope512 = gemma_mod._rope_tables(torch.clamp(mask512.cumsum(1) - 1, min=0), GDH,
                                      glcfg.rope_local_theta)
    timed("fused_attn_int8_layer_gemma",
          lambda: fused_attn_int8_layer_gemma(gx512, glayer, glq, mask512, grope512, glcfg),
          lambda: fused_attn_int8_layer_gemma_plain(gx512, glayer, glq, mask512, grope512, glcfg),
          2 * GT * GD * 2 + 2 * GD * (GHQ + GHKD) + 4 * (GHQ + 2 * GHKD + 2 * GD)
          + GT * (GDH * 4 + 4), {"int8": 2 * GT * GD * (2 * GHQ + 2 * GHKD),
                                 "bf16": float(4 * GH * GDH * (live512 * live512).sum())})
    gmlp = (gx512, 1.0 + glayer["pre_mlp_norm"], glq["w_gate"], glq["w_up"], glq["w_down"],
            1.0 + glayer["post_mlp_norm"])
    timed("fused_mlp_int8_layer_gemma",
          lambda: fused_mlp_int8_layer(*gmlp, act="gelu_tanh"),
          lambda: fused_mlp_int8_layer_plain(*gmlp, act="gelu_tanh"),
          2 * GT * GD * 2 + 3 * GD * GI + 4 * (2 * GI + 3 * GD), {"int8": 6 * GT * GD * GI})
    int8_products(lambda: fused_attn_int8_layer_gemma(gx512, glayer, glq, mask512, grope512, glcfg),
                  GT, [(GD, GHQ), (GD, GHKD), (GD, GHKD), (GHQ, GD)], "fused_attn_int8_layer_gemma")
    int8_products(lambda: fused_mlp_int8_layer(*gmlp, act="gelu_tanh"), GT,
                  [(GD, GI), (GD, GI), (GI, GD)], "fused_mlp_int8_layer_gemma")
    # B2 at (64, 64), full masks, in both forms (the qwen form's training
    # shape; phase 17 times it again on its own inputs)
    full64 = torch.ones((64, 64), dtype=torch.int32, device=dev)
    b2_64x64 = {}
    for name_, (q_, k_, v_, w_, cs_, sn_, kw_) in {
            "qwen": (qa, ka, va, wq, cos, sin, dict(kwargs, scale=1.0 / np.sqrt(DH))),
            "gemma": (gqa, gka, gva, gw1, gcs, gsn, gkw)}.items():
        q_, k_, v_ = q_[:64, :64].contiguous(), k_[:64, :64].contiguous(), v_[:64, :64].contiguous()
        cs_, sn_ = cs_[:64, :64].contiguous(), sn_[:64, :64].contiguous()
        hd_, nh_ = kw_["head_dim"], kw_["num_heads"]
        pairs_ = 64 * (64 * 65 / 2 if kw_["causal"] else 64 * 64)
        b2_64x64[name_] = {"ms": cuda_ms(lambda: fused_qknorm_rope_attention(
            q_, k_, v_, w_, w_, cs_, sn_, full64, **kw_), 20),
            **bound(2 * (q_.numel() * 2 + k_.numel() * 2) + cs_.numel() * 4 * 2 + full64.numel() * 4
                    + hd_ * 4 * 2, {"bf16": 4 * nh_ * hd_ * pairs_})}
    with torch.inference_mode():
        genc_ms = {
            "kernel": cuda_ms(lambda: gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg), 5),
            "plain": cuda_ms(lambda: gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg,
                                                             fused="plain"), 3),
            "int8_kernel": cuda_ms(lambda: gemma_mod.encode_pooled(
                gparams, gt[0], gt[1], gcfg, qlayers=gql, fused_layers=True), 5),
            "int8_plain": cuda_ms(lambda: gemma_mod.encode_pooled(
                gparams, gt[0], gt[1], gcfg, fused="plain", qlayers=gql, fused_layers=True), 2),
            "shape": [512, GS]}
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

    def b6_device_ms(q_, s_, u_, n=50):
        """The kernel's own device time per launch: at B=8 the wrapper's
        query quantization (~9 small torch ops) is host-bound and would
        hide the kernel from CUDA events around whole calls. So the
        kernel's entry point is launched n times on queries quantized
        once, all queued behind a sleep kernel, between two events; its
        output is first held bit-equal to the wrapper's."""
        import ctypes

        lib = _build.load()
        q8_, _ = quantize_queries(q_)
        u32 = u_.to(torch.int32).contiguous()
        (b_, d_), (c_, r_, _), p_ = q8_.shape, s_.shape, u32.shape[0]
        out_ = torch.empty((b_, p_ * r_), dtype=torch.int32, device=dev)
        stream_ = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def launch():
            _build.check(lib, lib.ts_ivf_scores(q8_.data_ptr(), s_.data_ptr(), u32.data_ptr(),
                                                out_.data_ptr(), b_, d_, c_, r_, p_, stream_),
                         "ivf_probe_scores")

        launch()
        if not torch.equal(out_, ivf_probe_scores(q_, s_, u_)[0]):
            raise AssertionError("B6's direct launch disagrees with its wrapper")
        return queued_ms(launch, n)

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
    times_line = dict(gpu=gpu, kernels=times,
         shapes={"mips_g_scan*": [1024, NC, D, rb, m], "mips_topk": [512, NC, D, 40],
                 "qknorm_rope_attention": [512, S, H, HK, DH],
                 "fused_*_int8_layer": [*x512.shape[:2], DM, I, H, HK, DH],
                 "qknorm_rope_attention_gemma": [512, GS, GH, GHK, GDH],
                 "fused_*_int8_layer_gemma": [*gx512.shape[:2], GD, GI, GH, GHK, GDH],
                 "ivf_probe_scores": {"B": 8, "P": P6, "R": R6, "D": D, "distinct_chunks": distinct6,
                                      "spill_chunks": n_spill_ch, "nprobe": int(np_cal)}},
         b2_at_64x64=b2_64x64, int8_product_ms=int8_product_ms, mips_g_scan_small_batch=b1_small,
         mips_g_scan_device_ms=b1_device_ms, mips_g_scan_gmask_computed_share=gneed_share,
         mips_topk_device_ms=b5_device_ms, mips_topk_more=b5_more,
         ivf_search_ms=lat, ivf_probe_scores_wrapper_ms=b6_wrapper_ms, b6_shapes=b6_shapes,
         scan_rescore_ms_per_batch={"kernel": pipe_k, "plain": pipe_p, "qps_kernel": 1024 / pipe_k * 1e3},
         encoder_forward_ms={"kernel": enc_k, "plain": enc_p, "shape": [512, S]},
         encoder_int8_forward_ms={"kernel": enc8_k, "plain": enc8_p, "shape": [512, S]},
         gemma_encoder_forward_ms=genc_ms, bert_forward_ms={"ms": bert_ms, "shape": list(bt.shape[1:])},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # a filtered batch of at most 32 signatures: ONE grouped scan
    grouped_batch = [f36[s_] for s_ in sig_of if s_ < 32]
    qg = qf[: len(grouped_batch)]
    for name, fn in (
        ("encoder_forward_512x64", lambda: encode_pooled(params, t[0], t[1], cfg)),
        ("encoder_int8_forward_512x64",
         lambda: encode_pooled(params, t[0], t[1], cfg, qlayers=ql, fused_layers=True)),
        ("gemma_encoder_forward_512x64", lambda: gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg)),
        ("gemma_encoder_int8_forward_512x64",
         lambda: gemma_mod.encode_pooled(gparams, gt[0], gt[1], gcfg, qlayers=gql, fused_layers=True)),
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

    # ---- 17. B7 vs plain (the 1M engines and their corpora freed first) ----
    del (engine, xeng, eng_ivf, ivf, flat_ivf, index, xindex, corpus_dev, ivf_dev, corpus,
         ivf_corpus, rescore_bf16, pa, cents_dev, bf_corpus, fn_cal, captured, cq, cs, cu,
         sched, service, direct, sched8, service8, direct8, fsched, fservice, isched, iservice,
         idirect, encoder, encoder8, params, ql, x512, layer, lq, biases, rows_nc, st36, year_dev,
         geng, gindex, gcorpus, gsched, gservice, gdirect, genc, genc8, gql, gx512, glayer, glq,
         gqa, gka, gva, gcs, gsn, gmlp, gparams, gk, gp, go, g8k, g8p)
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    def attn_bwd_inputs(bb, s_, full, seed, h=H, hk=HK):
        gb = torch.Generator(device=dev).manual_seed(seed)
        qa_ = (torch.randn((bb, s_, h * DH), generator=gb, device=dev) * 0.5).to(torch.bfloat16)
        ka_ = (torch.randn((bb, s_, hk * DH), generator=gb, device=dev) * 0.5).to(torch.bfloat16)
        va_ = (torch.randn((bb, s_, hk * DH), generator=gb, device=dev) * 0.5).to(torch.bfloat16)
        w_ = 1.0 + 0.1 * torch.randn((2, DH), generator=gb, device=dev)
        lens_ = torch.full((bb,), s_, device=dev) if full else torch.randint(
            1, s_ + 1, (bb,), generator=gb, device=dev)
        m_ = (torch.arange(s_, device=dev)[None, :] < lens_[:, None]).to(torch.int32)
        m_[:, 0] = 1
        pos_ = torch.clamp(m_.cumsum(1) - 1, min=0).float()
        ang_ = pos_[..., None] * (1.0 / (1e6 ** (torch.arange(0, DH, 2, device=dev).float() / DH)))
        g_ = (torch.randn((bb, s_, h * DH), generator=gb, device=dev) * m_[..., None]).to(torch.bfloat16)
        return (qa_, ka_, va_, w_[0].contiguous(), w_[1].contiguous(), torch.cos(ang_),
                torch.sin(ang_), m_, g_)

    bwd_kw = dict(num_heads=H, num_kv_heads=HK, head_dim=DH, eps=1e-6, causal=True)
    err_of["qknorm_rope_attention_bwd"] = 0.0
    # the tower's 16/8 heads, then mesh_train's 8/4 a shard at a data row's
    # (32, 64), full masks as its batches have
    for bb, s_, full, h7, hk7, seed7 in ((64, 32, False, H, HK, 732), (64, 64, False, H, HK, 764),
                                         (64, 128, False, H, HK, 828), (64, 64, True, H, HK, 765),
                                         (32, 64, True, H // 2, HK // 2, 766)):
        args7 = attn_bwd_inputs(bb, s_, full, seed7, h7, hk7)
        kw7 = {**bwd_kw, "num_heads": h7, "num_kv_heads": hk7}
        outk = fused_qknorm_rope_attention_bwd(*args7, **kw7)
        outk2 = fused_qknorm_rope_attention_bwd(*args7, **kw7)
        outp = fused_qknorm_rope_attention_bwd_plain(*args7, scale=1.0 / np.sqrt(DH), **kw7)
        torch.cuda.synchronize()
        repeat_equal = all(torch.equal(a_, b_) for a_, b_ in zip(outk, outk2))
        rows, ok7 = {}, repeat_equal
        for name, a_, b_, tol in zip(("dq", "dk", "dv", "dqw", "dkw"), outk, outp,
                                     (2e-2, 2e-2, 2e-2, 1e-3, 1e-3)):
            cosv, err, ref_max = agreement(a_, b_)
            rows[name] = {"cosine": cosv, "max_abs_err": err, "max_abs_plain": ref_max}
            ok7 &= cosv > 0.9999 and err <= tol * ref_max
            if name in ("dq", "dk", "dv"):
                err_of["qknorm_rope_attention_bwd"] = max(err_of["qknorm_rope_attention_bwd"], err)
        emit("b7", B=bb, S=s_, heads=[h7, hk7, DH], masks="full" if full else "ragged",
             repeat_bit_equal=repeat_equal, **rows)
        if not ok7:
            raise AssertionError(f"B7 kernel disagrees with its plain version at (B, S) = ({bb}, {s_}), "
                                 f"heads {h7}/{hk7}")
    del args7, outk, outk2, outp

    # B7 and B2 times at the training shape, full masks
    qa, ka, va, qw7, kw7, cos7, sin7, m7, g7 = attn_bwd_inputs(64, 64, True, 799)
    live7 = m7.sum(1).double()
    pairs7 = float((live7 * (live7 + 1) / 2).sum())
    in7 = (qa.numel() * 2 + ka.numel() * 2 * 2 + cos7.numel() * 4 * 2 + m7.numel() * 4 + DH * 4 * 2)
    timed("qknorm_rope_attention_bwd",
          lambda: fused_qknorm_rope_attention_bwd(qa, ka, va, qw7, kw7, cos7, sin7, m7, g7, **bwd_kw),
          lambda: fused_qknorm_rope_attention_bwd_plain(
              qa, ka, va, qw7, kw7, cos7, sin7, m7, g7, scale=1.0 / np.sqrt(DH), **bwd_kw),
          in7 + g7.numel() * 2 + qa.numel() * 2 + ka.numel() * 2 * 2 + DH * 4 * 2,
          {"bf16": 5 * 2 * DH * H * pairs7}, plain_iters=5)
    b2_train = {"ms": cuda_ms(lambda: fused_qknorm_rope_attention(
        qa, ka, va, qw7, kw7, cos7, sin7, m7, **kwargs), 20),
        **bound(in7 + qa.numel() * 2, {"bf16": 2 * 2 * DH * H * pairs7})}
    del qa, ka, va, g7

    # ---- 18. contrastive training at full width ----
    from theoremsearch_tpu_torch.core.config import TrainConfig
    from theoremsearch_tpu_torch.train.contrastive import (
        info_nce_loss, init_lora_train_state, init_train_state, make_lora_train_step,
        make_train_step, tree_leaves,
    )

    tcfg_ = TrainConfig(batch_size=64, seq_len=64, learning_rate=2e-5, temperature=0.05,
                        lora_rank=8)
    tr_cfg = EncoderConfig(max_seq_len=64)
    TB, TS, TSTEPS = 64, 64, 20
    rng_t = np.random.default_rng(0)
    tq, tp_ = train_tokens(rng_t, tr_cfg.vocab_size, TB, TS, TSTEPS)
    tq_dev = torch.from_numpy(tq).to(dev)
    tp_dev = torch.from_numpy(tp_).to(dev)
    tmask = torch.ones((TB, TS), dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()

    # (a) one batch's gradients through each attention route
    def batch_grads(fused):
        st_ = init_train_state(tr_cfg, tcfg_, device=dev)
        leaves_ = tree_leaves(st_.params)
        for t_ in leaves_:
            t_.requires_grad_(True)
        loss_ = info_nce_loss(st_.params, tq_dev[0], tmask, tp_dev[0], tmask, tr_cfg,
                              tcfg_.temperature, fused)
        grads_ = torch.autograd.grad(loss_, leaves_)
        names_ = ["embed", "final_norm"] + [f"{li}.{k_}" for li in range(tr_cfg.num_layers)
                                             for k_ in sorted(st_.params["layers"][0])]
        keep = {n_: g_.float() for n_, g_ in zip(names_, grads_)
                if n_ in ("embed", "final_norm") or n_.split(".")[0] in ("0", str(tr_cfg.num_layers - 1))}
        return float(loss_.detach()), keep

    loss_on, g_on = batch_grads("on")
    loss_plain, g_plain = batch_grads("plain")
    loss_off, g_off = batch_grads("off")
    cos_plain = {n_: agreement(g_on[n_], g_plain[n_])[0] for n_ in g_on}
    cos_off = {n_: agreement(g_on[n_], g_off[n_])[0] for n_ in g_on}
    del g_on, g_plain, g_off
    emit("train_grads", loss={"on": loss_on, "plain": loss_plain, "off": loss_off},
         cos_on_vs_plain_min=min(cos_plain.values()), cos_on_vs_off_min=min(cos_off.values()),
         cos_on_vs_plain=cos_plain, cos_on_vs_off=cos_off)
    if not min(cos_plain.values()) >= 0.999:
        raise AssertionError(f"train gradients: kernel vs plain cosine below 0.999: {cos_plain}")

    # (b), (c) 20 steps "on" (the path) and "off" from the same weights
    def run_steps(fused):
        st_ = init_train_state(tr_cfg, tcfg_, device=dev)
        step_ = make_train_step(tr_cfg, tcfg_, fused=fused)
        ls_, ev = [], [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for i_ in range(TSTEPS):
            if i_ == 2:
                ev[0].record()
            st_, l_ = step_(st_, tq_dev[i_], tmask, tp_dev[i_], tmask)
            ls_.append(l_)
        ev[1].record()
        ev[1].synchronize()
        return [float(l_) for l_ in ls_], ev[0].elapsed_time(ev[1]) / (TSTEPS - 2), st_, step_

    n_train_params = sum(t_.numel() for t_ in tree_leaves(init_params(
        EncoderConfig(num_layers=1, vocab_size=1), torch.Generator(device=dev).manual_seed(0),
        device=dev)["layers"]))
    path_start()
    losses_on, step_on_ms, st_on, step_fn = run_steps("on")
    path8 = path_end()
    peak_train_gb = torch.cuda.max_memory_allocated() / 2**30
    # one more "on" step under the profiler: kernel time by name, and the
    # device's busy share of the steady step time
    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_t:
        step_fn(st_on, tq_dev[0], tmask, tp_dev[0], tmask)
        torch.cuda.synchronize()
    krows = [e for e in prof_t.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in krows)
    b7_us = sum(e.self_device_time_total for e in krows if "attention_bwd" in e.key)
    b2_us = sum(e.self_device_time_total for e in krows if "qknorm_rope_attention_kernel" in e.key)
    emit("profile", what="train_step_on_64x64", gpu=gpu, kernel_ms=kernel_us / 1e3,
         device_busy_share_of_step=kernel_us / 1e3 / step_on_ms, b7_ms=b7_us / 1e3, b2_ms=b2_us / 1e3,
         top_device_us=[[e.key[:60], round(e.self_device_time_total, 1), e.count]
                        for e in sorted(krows, key=lambda e: -e.self_device_time_total)[:14]])
    del st_on, step_fn, prof_t
    losses_off, step_off_ms, _, _ = run_steps("off")
    drift = max(abs(a_ - b_) for a_, b_ in zip(losses_on, losses_off))
    tokens = 2 * TB * TS
    flops_ref = 6 * (28 * 15.7e6 + tr_cfg.vocab_size * tr_cfg.hidden_size) * tokens
    flops_no_embed = 6 * tr_cfg.num_layers * n_train_params * tokens
    per_step = {k_: v_ / TSTEPS for k_, v_ in path8.items()}
    train_ok = (all(np.isfinite(losses_on)) and losses_on[-1] < losses_on[0] and drift <= 2e-2
                and per_step["qknorm_rope_attention_bwd"] == 2 * tr_cfg.num_layers
                and per_step["qknorm_rope_attention"] == 2 * tr_cfg.num_layers)
    emit("train", layers=tr_cfg.num_layers, hidden=tr_cfg.hidden_size, batch_pairs=TB, seq_len=TS,
         steps=TSTEPS, losses_on=losses_on, losses_off=losses_off, max_abs_dloss_on_vs_off=drift,
         step_ms={"on": step_on_ms, "off": step_off_ms},
         tokens_per_s={"on": tokens / step_on_ms * 1e3, "off": tokens / step_off_ms * 1e3},
         model_tflops_per_s={"on": flops_ref / step_on_ms / 1e9, "off": flops_ref / step_off_ms / 1e9},
         model_tflops_per_s_without_embedding={"on": flops_no_embed / step_on_ms / 1e9,
                                                "off": flops_no_embed / step_off_ms / 1e9},
         peak_mem_gb=peak_train_gb, launches=path8, launches_per_step=per_step, gpu=gpu)
    if not train_ok:
        raise AssertionError("train phase failed")

    # (d) LoRA, rank 8 on wq / wv, 5 steps over frozen base weights
    base = init_train_state(tr_cfg, tcfg_, device=dev).params
    base_copy = [t_.clone() for t_ in tree_leaves(base)]
    lstate = init_lora_train_state(base, tcfg_)
    lstep = make_lora_train_step(tr_cfg, tcfg_)
    lora_losses = []
    for i_ in range(5):
        lstate, l_ = lstep(lstate, base, tq_dev[i_], tmask, tp_dev[i_], tmask)
        lora_losses.append(float(l_))
    base_same = all(torch.equal(a_, b_) for a_, b_ in zip(tree_leaves(base), base_copy))
    emit("train_lora", rank=8, targets=["wq", "wv"], losses=lora_losses,
         base_bit_unchanged=base_same)
    if not (base_same and all(np.isfinite(lora_losses))):
        raise AssertionError("LoRA train phase failed")
    del base, base_copy, lstate

    # ---- 18m. the dp + tp train step on a (2, 2) mesh of the card ----
    mesh_tr = mesh_train(dev, gpu, counters, path_start, path_end, tq=tq_dev, tp=tp_dev, tmask=tmask)

    # ---- 18g. the gemma tower trains at full width through its fused core ----
    gtr_cfg = GemmaEncoderConfig(max_seq_len=64)
    GSTEPS = 8
    gtq, gtp = train_tokens(rng_t, gtr_cfg.vocab_size, TB, TS, GSTEPS)
    gtq_dev, gtp_dev = torch.from_numpy(gtq).to(dev), torch.from_numpy(gtp).to(dev)

    def gemma_grads(fused):
        st_ = init_train_state(gtr_cfg, tcfg_, device=dev)
        leaves_ = tree_leaves(st_.params)
        for t_ in leaves_:
            t_.requires_grad_(True)
        loss_ = info_nce_loss(st_.params, gtq_dev[0], tmask, gtp_dev[0], tmask, gtr_cfg,
                              tcfg_.temperature, fused)
        grads_ = torch.autograd.grad(loss_, leaves_)
        # tree_leaves order: embed, final_norm, head_b1, head_b2, head_w1,
        # head_w2, then each layer's leaves by sorted key
        names_ = ["embed", "final_norm", "head_b1", "head_b2", "head_w1", "head_w2"] + [
            f"{li}.{k_}" for li in range(gtr_cfg.num_layers) for k_ in sorted(st_.params["layers"][0])]
        last = str(gtr_cfg.num_layers - 1)
        return float(loss_.detach()), {n_: g_.float() for n_, g_ in zip(names_, grads_)
                                       if n_ in ("embed", "final_norm") or n_.split(".")[0] in ("0", last)}

    torch.cuda.reset_peak_memory_stats()
    gl_on, gg_on = gemma_grads("on")
    gl_plain, gg_plain = gemma_grads("plain")
    gcos_grad = {n_: agreement(gg_on[n_], gg_plain[n_])[0] for n_ in gg_on}
    wq_grad_max = float(gg_on["0.wq"].abs().max())
    del gg_on, gg_plain
    gst = init_train_state(gtr_cfg, tcfg_, device=dev)
    gstep = make_train_step(gtr_cfg, tcfg_, fused="on")
    gls, gev = [], [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    path_start()
    for i_ in range(GSTEPS):
        if i_ == 2:
            gev[0].record()
        gst, l_ = gstep(gst, gtq_dev[i_], tmask, gtp_dev[i_], tmask)
        gls.append(l_)
    gev[1].record()
    gev[1].synchronize()
    path_gt = path_end()
    gstep_ms = gev[0].elapsed_time(gev[1]) / (GSTEPS - 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_g:
        gstep(gst, gtq_dev[0], tmask, gtp_dev[0], tmask)
        torch.cuda.synchronize()
    gkrows = [e for e in prof_g.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    gkernel_us = sum(e.self_device_time_total for e in gkrows)
    emit("profile", what="gemma_train_step_on_64x64", gpu=gpu, kernel_ms=gkernel_us / 1e3,
         device_busy_share_of_step=gkernel_us / 1e3 / gstep_ms,
         top_device_us=[[e.key[:60], round(e.self_device_time_total, 1), e.count]
                        for e in sorted(gkrows, key=lambda e: -e.self_device_time_total)[:14]])
    del prof_g
    gls = [float(l_) for l_ in gls]
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    emit("train_gemma", layers=gtr_cfg.num_layers, hidden=gtr_cfg.hidden_size,
         heads=[gtr_cfg.num_heads, gtr_cfg.num_kv_heads, gtr_cfg.head_dim], batch_pairs=TB,
         seq_len=TS, steps=GSTEPS, losses=gls, loss_one_batch={"on": gl_on, "plain": gl_plain},
         grad_cos_on_vs_plain_min=min(gcos_grad.values()), grad_cos_on_vs_plain=gcos_grad,
         wq_grad_max_abs=wq_grad_max, step_ms=gstep_ms, tokens_per_s=2 * TB * TS / gstep_ms * 1e3,
         peak_mem_gb=g_peak, launches=path_gt,
         launches_per_step={k_: v_ / GSTEPS for k_, v_ in path_gt.items()}, gpu=gpu)
    if not (all(np.isfinite(gls)) and gls[-1] < gls[0] and min(gcos_grad.values()) >= 0.999
            and wq_grad_max > 0 and path_gt["qknorm_rope_attention_gemma"]
            == GSTEPS * 2 * gtr_cfg.num_layers):
        raise AssertionError("train_gemma phase failed")
    del gst, gstep, gtq_dev, gtp_dev
    # the train CLI runs in another process: hand back the blocks this one
    # keeps cached (the train phases leave up to the whole card reserved)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19. the train entry point, with a checkpoint and a resume ----
    import shutil
    import subprocess
    import tempfile

    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cli_runs = []
    try:
        for steps_ in (10, 20):
            t0 = time.perf_counter()
            r_ = subprocess.run(
                [sys.executable, "-m", "theoremsearch_tpu_torch", "train", "--steps", str(steps_),
                 "--checkpoint-dir", ck_dir, "--checkpoint-every", "5", "--eval", "--log-every", "5",
                 "--validation", os.path.join(root, "data", "validation_set.csv")],
                cwd=root, env=env, capture_output=True, text=True, timeout=300)
            cli_runs.append((r_, time.perf_counter() - t0))
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    (r1, s1), (r2, s2) = cli_runs
    final_loss = (float(r2.stdout.split("final loss ")[1].split()[0])
                  if "final loss " in r2.stdout else float("nan"))
    after = [ln for ln in r2.stdout.splitlines() if ln.startswith("[train] after:")]
    emit("train_cli", rcs=[r1.returncode, r2.returncode], seconds=[round(s1, 3), round(s2, 3)],
         resumed="resumed at step 10" in r2.stdout, after=after[0][len("[train] after: "):] if after else None,
         final_loss=final_loss, stdout_tail=r2.stdout[-600:], stderr_tail=(r1.stderr + r2.stderr)[-600:])
    if not (r1.returncode == 0 and r2.returncode == 0 and "resumed at step 10" in r2.stdout
            and after and np.isfinite(final_loss)):
        raise AssertionError("train_cli phase failed")

    # ---- 23. the catalog -> engine -> CLI path at full width ----
    path_start()
    cc_checks = catalog_cli(dev, gpu, counters)["check_launches"]
    path_cc = path_end(aside=cc_checks)
    emit("catalog_cli", step="window", launches=path_cc, check_launches_taken_out=cc_checks,
         gpu=gpu)
    unlaunched = [k for k in ("mips_g_scan", "qknorm_rope_attention", "fused_attn_int8_layer",
                              "fused_mlp_int8_layer", "ivf_probe_scores", "qknorm_rope_attention_bwd")
                  if path_cc[k] < 1]
    if unlaunched:
        raise AssertionError(f"catalog_cli: kernels never launched in its window: {unlaunched}")

    # ---- 24. the run across processes: Gloo at world 2, NCCL at world 1,
    # then tensor parallelism across processes (24t, multiproc_tp) ----
    gc.collect()
    torch.cuda.empty_cache()
    multiproc_phases(dev, gpu, texts=texts, tq=tq[:MP_TRAIN_STEPS, : mesh_tr["batch_pairs"]],
                     tp=tp_[:MP_TRAIN_STEPS, : mesh_tr["batch_pairs"]],
                     mesh_losses=mesh_tr["losses"])

    # ---- 13. the times line ----
    emit("times", **times_line, b2_at_train_shape=b2_train, train_step_ms={
         "on": step_on_ms, "off": step_off_ms, "shape": [TB, TS, tr_cfg.num_layers]},
         gemma_train_step_ms={"on": gstep_ms, "shape": [TB, TS, gtr_cfg.num_layers]},
         shapes_train={"qknorm_rope_attention_bwd": [64, 64, H, HK, DH]},
         total_s=round(time.perf_counter() - t_start, 1))

    sources = {
        "mips_g_scan": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_g_scan_mask": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_g_scan_gmask": ("theoremsearch_tpu_torch/csrc/mips_g.cu", "theoremsearch_tpu/kernels/mips.py:300"),
        "mips_topk": ("theoremsearch_tpu_torch/csrc/mips_topk.cu", "theoremsearch_tpu/kernels/mips.py:75"),
        "qknorm_rope_attention": ("theoremsearch_tpu_torch/csrc/attention.cu",
                                  "theoremsearch_tpu/kernels/attention.py:60"),
        "qknorm_rope_attention_bwd": ("theoremsearch_tpu_torch/csrc/attention_bwd.cu",
                                      "theoremsearch_tpu/kernels/attention.py:225"),
        "fused_attn_int8_layer": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                  "theoremsearch_tpu/kernels/layer_int8.py:274"),
        "fused_mlp_int8_layer": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                 "theoremsearch_tpu/kernels/layer_int8.py:151"),
        "ivf_probe_scores": ("theoremsearch_tpu_torch/csrc/ivf_scores.cu",
                             "theoremsearch_tpu/kernels/mips.py:789"),
        "qknorm_rope_attention_gemma": ("theoremsearch_tpu_torch/csrc/attention.cu",
                                        "theoremsearch_tpu/kernels/attention.py:60"),
        "fused_attn_int8_layer_gemma": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                        "theoremsearch_tpu/kernels/layer_int8.py:274"),
        "fused_mlp_int8_layer_gemma": ("theoremsearch_tpu_torch/csrc/layer_int8.cu",
                                       "theoremsearch_tpu/kernels/layer_int8.py:151"),
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
