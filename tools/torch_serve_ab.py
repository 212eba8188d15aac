#!/usr/bin/env python3
"""Time served text -> ids latency of one checkout's port on the card.

    python tools/torch_serve_ab.py --root DIR [--label NAME]

Imports `theoremsearch_tpu_torch` from DIR (a checkout of the repository;
its kernels are built from DIR's own sources at first use) and builds
what `chip_smoke.py`'s serving phases build, from the same seeds: the
full-width Qwen3-0.6B-class encoder (`EncoderConfig()`, random weights)
in bf16 and int8, a 1,048,576 x 1024 global-scale int8 index of random
unit rows whose first 4,096 rows are the slogans' embeddings, and the
serving benchmark's metadata. For each mode it serves `POST /search`
through the scheduler and HTTP from 64 client threads: one warm round,
then ROUNDS measured rounds (one round's p50 swings 2-4x with the
batches it happens to form):

- `text` and `text_int8`: 128 slogan queries (the unmasked scan);
- `filtered`: 256 queries with filters from the 36-signature mix (the
  one-mask and grouped scans).

Prints one JSON line with, per mode, the scheduler's p50 / p99 latency
(ms, submit to result) and the batches of each round. Two checkouts
timed in one call (parent, change, change, parent) see the same data
and requests. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROUNDS = 6


def _smoke_helpers():
    """`slogans`, `bench_metadata` and `MIX36` from this checkout's
    chip_smoke.py, so that both trees serve the same texts and filters."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose theoremsearch_tpu_torch to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    helpers = _smoke_helpers()
    sys.path.insert(0, os.path.abspath(args.root))
    from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.model import init_params
    from theoremsearch_tpu_torch.index.flat import FlatIndex
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from theoremsearch_tpu_torch.serve.app import SearchService
    from theoremsearch_tpu_torch.serve.http_api import SearchServer
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler
    from theoremsearch_tpu_torch.utils.device import gpu_name_power

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"label": args.label or args.root, "gpu": gpu_name_power(), "rounds": ROUNDS}
    cfg = EncoderConfig()
    texts = helpers.slogans(4096)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    encoder = BatchedEncoder(params, cfg, batch_size=512, device=dev)
    encoder8 = BatchedEncoder(params, cfg, batch_size=512, device=dev, quant="int8")
    n, d = 1 << 20, cfg.embedding_dim
    corpus = np.empty((n, d), np.float32)
    g = torch.Generator(device=dev).manual_seed(7)
    for i in range(0, n, 131_072):
        x = torch.randn((131_072, d), generator=g, device=dev)
        corpus[i : i + 131_072] = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    corpus[:4096] = encoder.encode(texts)
    index = FlatIndex.build(corpus, config=IndexConfig(dtype="int8", int8_scale="global"), device=dev)
    engine = SearchEngine(index, meta=helpers.bench_metadata(n, texts, CorpusMetadata),
                          rescore_vectors=corpus, device=dev)
    del corpus

    qtexts = [texts[(37 * i) % 4096] for i in range(128)]
    pick = np.random.default_rng(13).integers(0, 36, 256)
    modes = {
        "text": (encoder, [{"query": t, "top_k": 10} for t in qtexts]),
        "text_int8": (encoder8, [{"query": t, "top_k": 10} for t in qtexts]),
        "filtered": (encoder, [{"query": texts[(53 * i) % 4096], "top_k": 10,
                                "filters": helpers.MIX36[p]} for i, p in enumerate(pick)]),
    }
    for name, (enc, bodies) in modes.items():
        sched = BatchScheduler(engine, max_batch=256, encode_fn=enc.encode_device)
        service = SearchService(engine, enc.encode, scheduler=sched)
        server = SearchServer(service, "127.0.0.1", 0).start()
        url = f"http://127.0.0.1:{server.port}/search"

        def post(body, url=url):
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                json.loads(r.read())
                return r.status

        out = {"p50": [], "p99": [], "batches": [], "wall_s": []}
        try:
            with ThreadPoolExecutor(64) as ex:
                if any(c != 200 for c in ex.map(post, bodies)):   # warm round
                    raise RuntimeError(f"{name}: a warm-round request failed")
                for _ in range(ROUNDS):
                    sched.reset_traces()
                    b0 = sched.stats()["batches"]
                    t0 = time.perf_counter()
                    if any(c != 200 for c in ex.map(post, bodies)):
                        raise RuntimeError(f"{name}: a request failed")
                    out["wall_s"].append(time.perf_counter() - t0)
                    st = sched.stats()
                    out["p50"].append(st["latency_ms"][0.5])
                    out["p99"].append(st["latency_ms"][0.99])
                    out["batches"].append(st["batches"] - b0)
        finally:
            server.stop()
            sched.shutdown()
        out["p50_median"] = float(np.median(out["p50"]))
        res[name] = out
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
