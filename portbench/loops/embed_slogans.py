"""Closed-loop slogan embedding, the index build and refresh path:
`pipeline.embed_missing_slogans(catalog, BatchedEncoder.encode (document
role), IndexBuilder, page_size)` called for `chunk` slogans at a time
until the window ends. The sqlite catalog is filled in set-up with more
slogans than the window can embed; catalog and spool live in a
temporary directory.

The check: the rows the spool holds for sampled slogans (with the
longest) against the float32 reference tower, every row it holds against
the reference tower in bf16, and the ids it holds against the slogans the
catalog pages out in order."""

from __future__ import annotations

import json
import shutil
import tempfile
import time

from pathlib import Path

import numpy as np
import torch

from portbench import judge, stack, textgen


def _fill(cat, texts: list[str], per_paper: int) -> None:
    """Papers, theorems and one slogan each, inserted in one transaction;
    slogan_id i + 1 is texts[i]."""
    n = len(texts)
    conn = cat.conn
    conn.executemany(
        "INSERT INTO paper (paper_id, title, authors, link, primary_category, citations)"
        " VALUES (?, ?, '[]', ?, 'math.AG', 0)",
        [(f"p{j}", f"Paper {j}", f"https://arxiv.org/abs/2401.{j:07d}")
         for j in range(-(-n // per_paper))])
    conn.executemany(
        "INSERT INTO theorem (theorem_id, paper_id, name, body, label, parsing_method)"
        " VALUES (?, ?, ?, '', '', 'scanner')",
        [(i + 1, f"p{i // per_paper}", f"Theorem {i}") for i in range(n)])
    conn.executemany(
        "INSERT INTO theorem_slogan (slogan_id, theorem_id, model, prompt_id, slogan)"
        " VALUES (?, ?, 'offline-stub', 'body-only-v1', ?)",
        [(i + 1, i + 1, t) for i, t in enumerate(texts)])
    conn.commit()


def setup(ctx) -> None:
    from theoremsearch_tpu_torch.core.config import IndexConfig
    from theoremsearch_tpu_torch.index.builder import IndexBuilder
    from theoremsearch_tpu_torch.ingest.catalog import Catalog
    from theoremsearch_tpu_torch.pipeline import embed_missing_slogans

    p, cfg, dev, seed = ctx.p, ctx.cfg, ctx.device, ctx.seed
    params = stack.make_weights(cfg, seed, dev)
    quant = "int8" if ctx.control == "int8" else cfg["serving"]["quant"]
    be = stack.batched_encoder(cfg, params, dev, quant)
    texts, words = stack.slogan_texts(p, seed)
    work = tempfile.mkdtemp(prefix="portbench-embed-")
    cat = Catalog(f"{work}/catalog.db")
    _fill(cat, texts, p["per_paper"])
    spool = IndexBuilder(f"{work}/spool", IndexConfig(dim=cfg["model"]["hidden_size"],
                                                        dtype="int8", int8_scale="global"))
    encode = be.for_role("document")
    spent = [0.0]
    cap = cfg["serving"]["max_seq_len"]
    length_of = {t: min(int(w) + 2, cap) for t, w in zip(texts, words)}
    calls = []

    def encode_fn(batch):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.encode_fn"):
            out = encode(batch)
        spent[0] += time.perf_counter() - t0
        calls.append((t0, [length_of[t] for t in batch]))
        return out

    # warm: every width bucket a page of slogans reaches, at the
    # sub-batch of 64 the encoder runs, then one page through the path
    vocab = textgen.vocabulary()
    longest = int(min(words.max() + 2, cfg["serving"]["max_seq_len"]))
    for w in be.buckets:
        be.encode([" ".join(vocab[: max(1, w - 4)])] * 64, role="document")
        if w >= longest:
            break
    embed_missing_slogans(cat, encode_fn, spool, page_size=p["page_size"], limit=p["page_size"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.state.update(be=be, cat=cat, spool=spool, embed=embed_missing_slogans,
                     encode_fn=encode_fn)
    ctx.keep = dict(work=work, texts=texts, words=words, spent=spent, calls=calls,
                    first=p["page_size"], builder_dir=f"{work}/spool")


def window(ctx) -> None:
    st, k, p = ctx.state, ctx.keep, ctx.p
    cap = ctx.cfg["serving"]["max_seq_len"]
    done = 0
    k["calls"].clear()
    t0 = ctx.begin_window()
    k["spent"][0] = 0.0
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        ctx.tick()
        n = st["embed"](st["cat"], st["encode_fn"], st["spool"], page_size=p["page_size"],
                        limit=p["chunk"])
        done += n
        if n == 0:
            break
    t1 = time.perf_counter()
    lengths = np.minimum(k["words"] + 2, cap)
    first = k["first"]
    ctx.attempted = done
    ctx.failed = 0
    ctx.e2e["embed_tokens_per_s"] = float(lengths[first : first + done].sum()) / (t1 - t0)
    ctx.readings.update(window_s=t1 - t0, encode_s=k["spent"][0])
    # (start, real lengths) of each encoder call, for the traced window's readers
    ctx.readings["encode_calls"] = list(k["calls"])
    k["done"] = done


def release(ctx) -> None:
    ctx.state["cat"].close()


def check(ctx) -> dict:
    k, cfg, p, dev = ctx.keep, ctx.cfg, ctx.p, ctx.device
    spool = Path(k["builder_dir"])
    man = json.loads((spool / "build_manifest.json").read_text())
    ids = [np.load(spool / f"{b['name']}.ids.npy") for b in man["batches"]]
    rows = np.concatenate([np.load(spool / f"{b['name']}.emb.npy") for b in man["batches"]])
    all_ids = np.concatenate(ids)
    want = np.arange(1, k["first"] + k["done"] + 1)
    id_errors = int(len(all_ids) != len(want)) + int(np.setxor1d(all_ids, want).size)
    n = len(all_ids)
    words = k["words"]
    longest = int(np.argmax(words[all_ids - 1])) if n else 0
    pick = judge.np_sample(n, p["sample"], textgen.seed_rng(ctx.seed, "sample"), longest)
    texts = [k["texts"][int(i) - 1] for i in all_ids]
    params = stack.make_weights(cfg, ctx.seed, dev)
    ref = stack.reference_embed(cfg, params, [texts[j] for j in pick], "f32", dev)
    prog = torch.from_numpy(rows[pick]).to(dev)
    # every row the window wrote, against the reference in bf16 (a wrong
    # row is far off; the float32 sample above holds the precision)
    every = torch.from_numpy(rows).to(dev)
    ref_all = stack.reference_embed(cfg, params, texts, "bf16", dev)
    out = {"embed_cos_gap": judge.cos_gap(prog, ref), "rows_cos_gap_bf16": judge.cos_gap(every, ref_all),
           "id_errors": float(id_errors)}
    if ctx.control is not None:
        r8 = stack.reference_embed(cfg, params, [texts[j] for j in pick], "int8", dev)
        r8_all = stack.reference_embed(cfg, params, texts, "int8", dev)
        ctx.notes["control"] = {"embed_cos_gap_reference_int8": judge.cos_gap(r8, ref),
                                "rows_cos_gap_bf16_reference_int8": judge.cos_gap(r8_all, ref_all)}
    shutil.rmtree(k["work"], ignore_errors=True)
    return out
