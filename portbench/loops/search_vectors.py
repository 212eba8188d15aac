"""Closed-loop batched vector search: B = batch query vectors a call
through `SearchEngine.search_vectors` (host arrays in, host ids out; the
speed route: B1's scan, then the bf16 rescore), one call after another.
The vectors are the tower's own (bf16 reference) embeddings of seeded
queries that paraphrase the corpus's slogans, made in set-up and cycled.

The check: the ids and scores of sampled calls against the exact top-k
of the same vectors over the same corpus rows (`judge`). The calls kept
are every batch of one cycle through the batches in `keep_every`, from a
seeded offset, so every batch is judged."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import judge, stack, textgen


def setup(ctx) -> None:
    p, cfg, dev, seed = ctx.p, ctx.cfg, ctx.device, ctx.seed
    params = stack.make_weights(cfg, seed, dev)
    engine, corpus, texts, _ = stack.serving_index(cfg, p, seed, params, dev)
    b, nb = p["batch"], p["query_batches"]
    qtexts, _ = stack.queries(p, seed, texts, b * nb, "vectors")
    q = stack.reference_embed(cfg, params, qtexts, "bf16", dev).cpu().numpy()
    del params
    batches = [np.ascontiguousarray(q[i * b : (i + 1) * b]) for i in range(nb)]
    for qb in batches:
        engine.search_vectors(qb, k=p["top_k"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.state.update(engine=engine)
    ctx.keep = dict(corpus=corpus, batches=batches,
                    every=int(textgen.seed_rng(seed, "keep").integers(0, p["keep_every"])))


def window(ctx) -> None:
    engine, k, p = ctx.state["engine"], ctx.keep, ctx.p
    nb, every = len(k["batches"]), p["keep_every"]
    kept = []
    calls = 0
    in_trace = 0
    t0 = ctx.begin_window()
    end = t0 + ctx.seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        ctx.tick()
        tracing = ctx.tracing
        j = calls % nb
        s, i = engine.search_vectors(k["batches"][j], k=p["top_k"])
        if (calls // nb) % every == k["every"]:
            kept.append((j, s, i))
        calls += 1
        in_trace += tracing
    t1 = time.perf_counter()
    ctx.attempted = calls * p["batch"]
    ctx.failed = 0
    ctx.e2e["search_qps"] = calls * p["batch"] / (t1 - t0)
    ctx.readings.update(calls_in_trace=in_trace, batch=p["batch"], corpus_rows=p["corpus_rows"],
                        dim=ctx.cfg["model"]["hidden_size"])
    k["kept"] = kept


def release(ctx) -> None:
    ctx.state.pop("engine", None)


def check(ctx) -> dict:
    k, p, dev = ctx.keep, ctx.p, ctx.device
    out = {"recall_miss": 0.0, "score_gap": 0.0, "rank_errors": 0.0}
    if not k["kept"]:
        return {key: float("inf") for key in out}
    exact = {}
    ctl = []
    misses = []
    for j, s, i in k["kept"]:
        q = torch.from_numpy(k["batches"][j]).to(dev)
        if j not in exact:
            exact[j] = judge.exact_deep(q, k["corpus"], p["top_k"])
            if ctx.control is not None:
                ctl.append(judge.search_control(q, k["corpus"], p["top_k"], exact=exact[j]))
        r = judge.search_numbers(q, torch.as_tensor(np.asarray(i), dtype=torch.long),
                                 torch.as_tensor(np.asarray(s)), k["corpus"], p["top_k"],
                                 exact=exact[j])
        misses.append(r["recall_miss"])
        out["score_gap"] = max(out["score_gap"], r["score_gap"])
        out["rank_errors"] += r["rank_errors"]
    out["recall_miss"] = float(np.mean(misses))
    if ctl:
        ctx.notes["control"] = {"recall_miss_int8": float(np.mean([c["recall_miss"] for c in ctl])),
                                "score_gap_int8": max(c["score_gap"] for c in ctl),
                                "rank_errors_int8": sum(c["rank_errors"] for c in ctl)}
    ctx.notes["kept_calls"] = len(k["kept"])
    ctx.notes["kept_batches"] = sorted({j for j, _, _ in k["kept"]})
    return out
