"""Open-loop text serving: Poisson arrivals at a fixed rate of
`POST /search` (k = top_k, no filters, no rerank) against the serving
stack the CLI's `serve --warm` builds: `SearchServer` -> `SearchService`
-> `BatchScheduler.submit_text` (max_batch, max_wait_ms, max_pending) ->
`BatchedEncoder.encode_device` (query role) -> `SearchEngine` (speed
route: B1, then the bf16 rescore) -> the metadata join.

The generator is `http_load.py` in a child process. The check follows
every request of the window through its stages from what the program
produced: the query embeddings the encoder returned against the float32
reference tower; the returned ids and scores against the exact top-k of
those embeddings; the joined metadata against the corpus layout."""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench import judge, meta, stack, textgen


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def _spawn(port: int, bodies: list, offsets, keep: list, p: dict):
    """The load generator, started and ready for its "go"."""
    child = subprocess.Popen([sys.executable, str(Path(__file__).with_name("http_load.py"))],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    child.stdin.write(json.dumps({
        "host": "127.0.0.1", "port": port, "offsets": np.asarray(offsets).tolist(),
        "bodies": bodies, "keep": keep, "threads": p["client_threads"],
        "drain_s": p["drain_s"]}) + "\n")
    child.stdin.flush()
    if child.stdout.readline().strip() != "ready":
        raise RuntimeError("the load generator did not start")
    return child


def _go(child, tick) -> dict:
    """Start the generator's schedule; its result once every request has
    completed or failed (`tick` runs meanwhile)."""
    got = []
    child.stdin.write("go\n")
    child.stdin.flush()
    reader = threading.Thread(target=lambda: got.append(child.stdout.readline()))
    reader.start()
    while reader.is_alive():
        tick()
        reader.join(timeout=0.02)
    child.wait(timeout=30)
    return json.loads(got[0])


def offer(ctx, rate: float, seconds: float) -> dict:
    """One open-loop round at `rate` for the knee's sweep (no check)."""
    p, sched = ctx.p, ctx.state["sched"]
    n = max(1, int(round(rate * seconds)))
    qtexts, _ = stack.queries(p, ctx.seed + int(rate), ctx.keep["texts"], n, "knee")
    offsets = textgen.exponential_offsets(n, rate, textgen.seed_rng(ctx.seed, f"knee{rate}"))
    child = _spawn(ctx.state["srv"].port, [{"query": t, "top_k": p["top_k"]} for t in qtexts],
                   offsets, [], p)
    s0 = sched.stats()
    t0 = time.perf_counter()
    reqs = _go(child, lambda: None)["requests"]
    wall = time.perf_counter() - t0
    s1 = sched.stats()
    ok = [r for r in reqs if r[2] == 200]
    lat = [1000.0 * r[1] for r in ok] or [float("nan")]
    fifth = max(1, n // 5)
    by_due = sorted(range(n), key=lambda i: offsets[i])
    first = [1000.0 * reqs[i][1] for i in by_due[:fifth] if reqs[i][2] == 200] or [float("nan")]
    last = [1000.0 * reqs[i][1] for i in by_due[-fifth:] if reqs[i][2] == 200] or [float("nan")]
    done_in = sum(1 for r in ok if r[1] <= seconds)
    batches = s1["batches"] - s0["batches"]
    return {"rate_qps": rate, "offered": n, "ok": len(ok), "refused_429": sum(r[2] == 429 for r in reqs),
            "failed": n - len(ok), "wall_s": wall, "completed_qps": len(ok) / wall,
            "p50_ms": _pct(lat, 50), "p95_ms": _pct(lat, 95), "p99_ms": _pct(lat, 99),
            "p50_first_fifth_ms": _pct(first, 50), "p50_last_fifth_ms": _pct(last, 50),
            "latency_under_window_share": done_in / n,
            "batch_mean": (s1["queries"] - s0["queries"]) / batches if batches else None,
            "late_p99_ms": _pct([1000.0 * r[0] for r in reqs], 99)}


def setup(ctx) -> None:
    from theoremsearch_tpu_torch.serve.app import SearchService
    from theoremsearch_tpu_torch.serve.http_api import SearchServer
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

    p, cfg, dev, seed = ctx.p, ctx.cfg, ctx.device, ctx.seed
    params = stack.make_weights(cfg, seed, dev)
    quant = "int8" if ctx.control == "int8" else cfg["serving"]["quant"]
    be = stack.batched_encoder(cfg, params, dev, quant)
    engine, corpus, texts, pos = stack.serving_index(cfg, p, seed, params, dev)
    n = max(1, int(round(p["rate_qps"] * ctx.seconds)))
    qtexts, qwords = stack.queries(p, seed, texts, n, "queries")
    offsets = textgen.exponential_offsets(n, p["rate_qps"], textgen.seed_rng(seed, "arrivals"))
    words_of = dict(zip(qtexts, qwords.tolist()))
    log = []

    def encode_fn(batch):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.encode_fn"):
            out = be.encode_device(batch, role="query")
        log.append((t0, time.perf_counter(), batch, out))
        return out

    srv_cfg = cfg["serving"]
    sched = BatchScheduler(engine, max_batch=srv_cfg["max_batch"], max_wait_ms=srv_cfg["max_wait_ms"],
                           encode_fn=encode_fn, max_pending=srv_cfg["max_pending"])
    svc = SearchService(engine, be.for_role("query"), scheduler=sched)
    srv = SearchServer(svc, host="127.0.0.1", port=0).start()

    # warm the shapes this traffic reaches: encoder batch buckets 8..64 at
    # the two widths queries of up to 126 words fill, the multi-piece
    # batches, every scan batch bucket at k = top_k, and the HTTP path
    vocab = textgen.vocabulary()
    for w in be.buckets:
        if w > max(qwords) + 2 and w != be.buckets[0]:
            break
        text = " ".join(vocab[: max(1, w - 4)])
        for b in (8, 16, 32, 64, 128, 256):
            be.encode_device([text] * b, role="query")
    for b in (8, 16, 32, 64, 128, 256):
        engine.search_vectors(np.zeros((b, engine.dim), np.float32), k=p["top_k"])

    import http.client

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/search", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        conn.getresponse().read()
        conn.close()

    warm = [{"query": t, "top_k": p["top_k"]} for t in stack.queries(p, seed, texts, 256, "warm")[0]]
    with ThreadPoolExecutor(32) as pool:
        list(pool.map(post, warm))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log.clear()

    child = _spawn(srv.port, [{"query": t, "top_k": p["top_k"]} for t in qtexts], offsets,
                   list(range(n)), p)
    ctx.state.update(be=be, engine=engine, sched=sched, srv=srv, child=child)
    ctx.keep = dict(corpus=corpus, texts=texts, qtexts=qtexts, qwords=qwords,
                    log=log, words_of=words_of, n=n, offsets=offsets)


def window(ctx) -> None:
    sched, child, k = ctx.state["sched"], ctx.state["child"], ctx.keep
    sched.reset_traces()
    s0 = sched.stats()
    ctx.begin_window()
    res = _go(child, ctx.tick)
    t_end = time.perf_counter()
    s1 = sched.stats()
    reqs = res["requests"]
    ok = [r[2] == 200 for r in reqs]
    cap = 1000.0 * (float(k["offsets"][-1]) + ctx.p["drain_s"])
    lat = [1000.0 * r[1] if good else cap for r, good in zip(reqs, ok)]
    ctx.attempted = len(reqs)
    ctx.failed = int(len(reqs) - sum(ok))
    ctx.e2e["serve_p95_ms"] = _pct(lat, 95)
    ctx.e2e["serve_p50_ms"] = _pct(lat, 50)
    late = [1000.0 * r[0] for r in reqs]
    ctx.notes["generator"] = {"late_p50_ms": _pct(late, 50), "late_p99_ms": _pct(late, 99),
                              "late_max_ms": max(late), "status_counts": {
                                  str(s): sum(1 for r in reqs if r[2] == s)
                                  for s in sorted({r[2] for r in reqs})}}
    batches = s1["batches"] - s0["batches"]
    stages = s1.get("stages_ms", {})
    ctx.readings.update(
        batch_mean=(s1["queries"] - s0["queries"]) / batches if batches else None,
        queue_ms_p99=stages.get("queue_ms", {}).get("p99"),
        encode_ms_p50=stages.get("encode_ms", {}).get("p50"),
        window_s=t_end - ctx.window_start)
    # (start, real lengths) of each encoder call, for the traced window's readers
    ctx.readings["encode_calls"] = [(a, [k["words_of"][t] + 2 for t in batch])
                                    for a, _, batch, _ in k["log"]]
    # the requests' embeddings, to the host before the program goes
    qp = {}
    for _, _, batch, out in k["log"]:
        rows = out[: len(batch)].float().cpu()
        for t, r in zip(batch, rows):
            qp.setdefault(t, r)
    k["qp"] = qp
    k["bodies"] = {int(i): b for i, b in res["kept"].items()}
    k["log"] = None


def release(ctx) -> None:
    st = ctx.state
    st["srv"].stop()
    st["sched"].shutdown()
    child = st["child"]
    if child.poll() is None:
        child.kill()
        child.wait()


def check(ctx) -> dict:
    k, cfg, p, dev = ctx.keep, ctx.cfg, ctx.p, ctx.device
    sample = range(k["n"])
    n_rows = p["corpus_rows"]
    slogan_of = {int(r): t for r, t in zip(k["corpus"].positions.tolist(), k["texts"])}
    mismatches = 0
    answered = []
    for i in sample:
        body = k["bodies"].get(i)
        try:
            rows = json.loads(body)["results"]
        except (TypeError, ValueError, KeyError):
            mismatches += 1
            continue
        if len(rows) != p["top_k"] or k["qtexts"][i] not in k["qp"]:
            mismatches += 1
            continue
        fields = ("doc_id", "paper_id", "paper_title", "paper_url", "year", "primary_category",
                  "journal_published", "citations", "theorem_name", "theorem_slogan")
        for r in rows:
            want = meta.expected_row(n_rows, int(r["doc_id"]), slogan_of)
            if any(r.get(f) != want[f] for f in fields):
                mismatches += 1
                break
        answered.append((i, rows))
    params = stack.make_weights(cfg, ctx.seed, dev)
    texts = [k["qtexts"][i] for i, _ in answered]
    ref = stack.reference_embed(cfg, params, texts, "f32", dev)
    qp = torch.stack([k["qp"][t] for t in texts]).to(dev)
    ids = torch.tensor([[r["doc_id"] for r in rows] for _, rows in answered], device=dev)
    sims = torch.tensor([[r["similarity"] for r in rows] for _, rows in answered], device=dev)
    ex = judge.exact_deep(qp, k["corpus"], p["top_k"])
    out = {"query_cos_gap": judge.cos_gap(qp, ref),
           **judge.search_numbers(qp, ids, sims, k["corpus"], p["top_k"], exact=ex),
           "answer_errors": float(mismatches)}
    if ctx.control is not None:
        r8 = stack.reference_embed(cfg, params, texts, "int8", dev)
        ctx.notes["control"] = {"query_cos_gap_reference_int8": judge.cos_gap(r8, ref),
                                **{f"{a}_int8": b for a, b in judge.search_control(
                                    qp, k["corpus"], p["top_k"], exact=ex).items()}}
    return out
