"""Closed-loop slogan embedding through a tower that routes its tokens to
experts (the deepseek tower): `loops/embed_slogans.py`'s catalog fill and
window, over this configuration's weights and encoder. Besides that loop's
readings it keeps each encoder call's slogans, and the expert layers'
counters (`BatchedEncoder.stats()["moe"]`) at the traced sub-window's
start and end (`moe_t0`, `moe_t1`).

The check, after the window:
- `replay_gap`: every call that holds one of the sampled rows (the
  longest included) is encoded again, through the same encoder with the
  routing recorder on, at the same shapes; the widest |difference| between
  the spool's rows of those calls and the replay's. The forward has no
  atomics and sizes nothing from device data, so it is 0.
- `embed_cos_gap`: the sampled rows against the float32 reference forced
  to the recorded routing (widest 1 - cos).
- `route_far_picks`: recorded picks whose float32 reference biased score
  lies more than TAU below the reference's own k-th best at that token and
  layer. The program routes on bf16 hidden states, the reference on f32
  ones, so near-ties between the k-th and the next expert may swap; a
  pick far below the k-th best is a routing fault, not a rounding.
- `route_miss_share`: the share of recorded picks outside the reference's
  own top k. Near-ties swap about 2% of them; a router that leaves out
  e_score_correction_bias swaps about 10%, though almost none of its picks
  lies more than TAU below the k-th best (the bias spans about 0.1).
- `id_errors`: the ids spooled against those paged.
Readings: `route_worst_below_kth` (the farthest a recorded pick's
reference score lies below the k-th best), `expert_rows_max_over_mean`
(the busiest expert's rows over the mean an expert, over the layer calls
of the run).

With a control (`calibrate.py`), beside the reference's int8 and bf16
modes and a routing one expert off: the sampled calls encoded again by
the program with a faulty router, its picks held to the reference forced
to them as above: `route_miss_share_unbiased` (the top k of the scores
without the bias) and `route_miss_share_bf16_router` (the router's
product in bf16, as a bf16 linear layer gives it)."""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import deepseek, judge, spec, stack, textgen
from portbench.reference import deepseek as reference
from portbench.reference.tokenizer import HashTokenizer

_base = spec.load_module(spec.PKG / "loops" / "embed_slogans.py", "loop_embed_slogans_for_routed")

# In sigmoid-score units. Sound runs at full width put no recorded pick more
# than 0.030 below the f32 reference's k-th best (`route_worst_below_kth`,
# 0.024-0.030 over 12 seeds): the program routes on bf16 hidden states,
# the reference on f32 ones. A pick one expert off (the control's
# `route_far_picks_shifted`) lies ~0.2 below on average. A router without
# the bias puts almost no pick past TAU (0-7 of ~10^6 at full width) but
# ~10% of them outside the top k: `route_miss_share` is the check that
# sees it.
TAU = 0.1


def setup(ctx) -> None:
    from theoremsearch_tpu_torch.core.config import IndexConfig
    # first: a port without the tower fails here, before 31 GB of weights are drawn
    from theoremsearch_tpu_torch.encoder.deepseek import DeepseekEncoderConfig  # noqa: F401
    from theoremsearch_tpu_torch.index.builder import IndexBuilder
    from theoremsearch_tpu_torch.ingest.catalog import Catalog
    from theoremsearch_tpu_torch.pipeline import embed_missing_slogans

    p, cfg, dev, seed = ctx.p, ctx.cfg, ctx.device, ctx.seed
    model = deepseek.model_of(cfg)
    params = deepseek.make_weights(cfg, seed, dev)
    be = deepseek.batched_encoder(cfg, params, dev)
    texts, words = stack.slogan_texts(p, seed)
    work = tempfile.mkdtemp(prefix="portbench-embed-routed-")
    cat = Catalog(f"{work}/catalog.db")
    _base._fill(cat, texts, p["per_paper"])
    spool = IndexBuilder(f"{work}/spool", IndexConfig(dim=model["hidden_size"], dtype="int8",
                                                        int8_scale="global"))
    encode = be.for_role("document")
    spent = [0.0]
    cap = cfg["serving"]["max_seq_len"]
    length_of = {t: min(int(w) + 2, cap) for t, w in zip(texts, words)}
    calls, batches = [], []

    def encode_fn(batch):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.encode_fn"):
            out = encode(batch)
        spent[0] += time.perf_counter() - t0
        calls.append((t0, [length_of[t] for t in batch]))
        batches.append(list(batch))
        return out

    vocab = textgen.vocabulary()
    longest = int(min(words.max() + 2, cap))
    for w in be.buckets:
        be.encode([" ".join(vocab[: max(1, w - 4)])] * 64, role="document")
        if w >= longest:
            break
    batches.clear()
    embed_missing_slogans(cat, encode_fn, spool, page_size=p["page_size"], limit=p["page_size"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.state.update(be=be, cat=cat, spool=spool, embed=embed_missing_slogans,
                     encode_fn=encode_fn)
    ctx.keep = dict(work=work, texts=texts, words=words, spent=spent, calls=calls,
                    batches=batches, be=be, params=params, first=p["page_size"],
                    builder_dir=f"{work}/spool")


def _moe_now(be) -> dict:
    return be.stats().get("moe", {})


def window(ctx) -> None:
    be, tick = ctx.keep["be"], ctx.tick

    def tick_and_read():
        tick()
        if ctx.tracing and "moe_t0" not in ctx.readings:
            ctx.readings["moe_t0"] = _moe_now(be)
        elif "moe_t0" in ctx.readings and not ctx.tracing and "moe_t1" not in ctx.readings:
            ctx.readings["moe_t1"] = _moe_now(be)

    ctx.tick = tick_and_read
    try:
        _base.window(ctx)
    finally:
        ctx.tick = tick
    if ctx.tracing and "moe_t1" not in ctx.readings:
        ctx.readings["moe_t1"] = _moe_now(be)


def release(ctx) -> None:
    ctx.state["cat"].close()


def _recorded_picks(records: list) -> dict:
    """{text index in the call: (n_moe, len, k) picks on the host}."""
    out = {}
    for rec in records:
        picks = rec["picks"].cpu()
        at = 0
        for i, n in zip(rec["rows"], rec["lengths"]):
            out[i] = picks[:, at : at + n]
            at += n
    return out


def _replay(be, batches, pick, call_of, pos_of, embs=None) -> tuple[float, dict]:
    """Encode again every call holding a sampled row, the routing recorder
    on: (the widest |difference| of the calls' rows from `embs`' (0 without
    it), {sampled row: its picks})."""
    gap, routes = 0.0, {}
    for j in sorted(set(call_of[pick].tolist())):
        be.start_routing_record()
        again = be.encode(batches[j], role="document")
        recs = _recorded_picks(be.stop_routing_record())
        if embs is not None:
            gap = max(gap, float(np.abs(again - embs[j]).max()))
        for q in pick[call_of[pick] == j]:
            routes[int(q)] = recs[int(pos_of[q])]
    return gap, routes


def _route_numbers(route: list, diag: list, k: int) -> tuple[int, float, float]:
    """(picks more than TAU below the reference's k-th best biased score,
    the share of picks outside its top k, the farthest below)."""
    far = miss = total = 0
    worst = 0.0
    for r, d in zip(route, diag):
        kth = d.topk(k, dim=-1).values[..., -1:]
        got = d.gather(-1, r.long())
        far += int((got < kth - TAU).sum())
        miss += int((got < kth).sum())
        total += got.numel()
        worst = max(worst, float((kth - got).max()))
    return far, miss / max(total, 1), worst


def _faulty_router(kind: str):
    """The program's router with a fault, for the control: "unbiased"
    picks the top k of the scores without e_score_correction_bias;
    "bf16_router" takes the router's product in bf16 (bf16 operands and
    result, as a bf16 linear layer gives it)."""
    from theoremsearch_tpu_torch.encoder import deepseek as tower
    from theoremsearch_tpu_torch.utils.device import tf32_off

    def route(layer, xr, cfg):
        if kind == "bf16_router":
            logits = (xr.to(torch.bfloat16) @ layer["router"].to(torch.bfloat16).T).float()
            bias = layer["router_bias"]
        else:
            with tf32_off():
                logits = xr.float() @ layer["router"].float().T
            bias = torch.zeros_like(layer["router_bias"])
        scores = torch.sigmoid(logits)
        _, top = torch.topk(scores + bias, cfg.num_experts_per_tok, dim=-1)
        w = scores.gather(1, top)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return top, w * cfg.routed_scaling_factor

    return tower, route


def check(ctx) -> dict:
    k, cfg, p, dev = ctx.keep, ctx.cfg, ctx.p, ctx.device
    model = deepseek.model_of(cfg)
    be = k["be"]
    moe = be.stats()["moe"]
    spool = Path(k["builder_dir"])
    man = json.loads((spool / "build_manifest.json").read_text())
    ids = [np.load(spool / f"{b['name']}.ids.npy") for b in man["batches"]]
    embs = [np.load(spool / f"{b['name']}.emb.npy") for b in man["batches"]]
    all_ids = np.concatenate(ids)
    want = np.arange(1, k["first"] + k["done"] + 1)
    id_errors = int(len(all_ids) != len(want)) + int(np.setxor1d(all_ids, want).size)
    n = len(all_ids)
    words = k["words"]
    longest = int(np.argmax(words[all_ids - 1])) if n else 0
    pick = judge.np_sample(n, p["sample"], textgen.seed_rng(ctx.seed, "sample"), longest)
    # spool batch j is encoder call j: (call, position) of every spooled row
    call_of = np.concatenate([np.full(len(b), j) for j, b in enumerate(ids)])
    pos_of = np.concatenate([np.arange(len(b)) for b in ids])
    gap, routes = _replay(be, k["batches"], pick, call_of, pos_of, embs)
    tok = HashTokenizer(model["vocab_size"])
    texts = [k["texts"][int(all_ids[q]) - 1] for q in pick]
    seqs = [tok.ids(t, cfg["serving"]["max_seq_len"]) for t in texts]
    route = [routes[int(q)] for q in pick]
    prog = torch.from_numpy(np.stack([embs[call_of[q]][pos_of[q]] for q in pick])).to(dev)
    diag: list = []
    ref = reference.embed(k["params"], model, seqs, "f32", dev, route=route, diag=diag)
    kk = model["num_experts_per_tok"]
    far, miss, worst = _route_numbers(route, diag, kk)
    pairs = sum(c["pairs"] for c in moe.values())
    max_rows = sum(c["max_rows"] for c in moe.values())
    out = {"replay_gap": gap, "embed_cos_gap": judge.cos_gap(prog, ref),
           "route_far_picks": float(far), "route_miss_share": miss, "id_errors": float(id_errors),
           "route_worst_below_kth": worst,
           "expert_rows_max_over_mean": max_rows * model["n_routed_experts"] / max(pairs, 1)}
    if ctx.control is not None:
        control = {f"embed_cos_gap_reference_{mode}": judge.cos_gap(
            reference.embed(k["params"], model, seqs, mode, dev, route=route), ref)
            for mode in ("int8", "bf16")}
        # a routing fault: every pick one expert further on
        control["route_far_picks_shifted"] = float(sum(
            int((d.gather(-1, (r.long() + 1) % d.shape[-1])
                 < d.topk(kk, dim=-1).values[..., -1:] - TAU).sum())
            for r, d in zip(route, diag)))
        for kind in ("unbiased", "bf16_router"):
            tower, faulty = _faulty_router(kind)
            sound, tower.route = tower.route, faulty
            try:
                _, froutes = _replay(be, k["batches"], pick, call_of, pos_of)
            finally:
                tower.route = sound
            froute = [froutes[int(q)] for q in pick]
            fdiag: list = []
            reference.embed(k["params"], model, seqs, "f32", dev, route=froute, diag=fdiag)
            ffar, fmiss, _ = _route_numbers(froute, fdiag, kk)
            control[f"route_miss_share_{kind}"] = fmiss
            control[f"route_far_picks_{kind}"] = float(ffar)
        ctx.notes["control"] = control
    if ctx.summary is not None and "moe_t1" in ctx.readings:
        a, b = ctx.readings["moe_t0"], ctx.readings["moe_t1"]
        counted = sum(b[w]["launches"] - a.get(w, {}).get("launches", 0) for w in b)
        traced = sum(1 for cat, name, *_ in ctx.summary["device"]
                     if cat == "kernel" and deepseek.GROUPED_KERNEL in name)
        ctx.notes["moe_launches"] = {"counted": counted, "traced": traced}
    k.pop("be", None)
    k.pop("params", None)
    shutil.rmtree(k["work"], ignore_errors=True)
    return out
