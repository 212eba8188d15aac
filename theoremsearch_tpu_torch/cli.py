"""Command line of the port (counterpart of theoremsearch_tpu/cli.py): the
reference's fourteen subcommands. The host subcommands ingest, parse and
rate on the CPU, through the catalog alone; the device subcommands run on
the card unless `--device cpu` is given.

    python -m theoremsearch_tpu_torch ingest-arxiv --categories math.AG --date-partition week
    python -m theoremsearch_tpu_torch locate-s3 --bundle-start 0
    python -m theoremsearch_tpu_torch parse --timeout 30 --limit 100
    python -m theoremsearch_tpu_torch stacks --parsed stacks_parsed.zip --tags tags
    python -m theoremsearch_tpu_torch slogans --model offline-stub --prompt-id body-only-v1
    python -m theoremsearch_tpu_torch ingest-tex paper.tex --title "My notes"
    python -m theoremsearch_tpu_torch quality --sample 20
    python -m theoremsearch_tpu_torch --catalog catalog.db embed --model-dir M --spool ./spool
    python -m theoremsearch_tpu_torch --catalog catalog.db build-ivf --spool ./spool --calibrate
    python -m theoremsearch_tpu_torch --catalog catalog.db search "chromatic number bound"
    python -m theoremsearch_tpu_torch --catalog catalog.db serve --model-dir M --warm \\
        --refresh-interval 5
    python -m theoremsearch_tpu_torch eval --model-dir M
    python -m theoremsearch_tpu_torch compare-embedders --families qwen gemma bert
    python -m theoremsearch_tpu_torch train --steps 100 --checkpoint-dir ckpt --eval
    python -m theoremsearch_tpu_torch train --device cpu --steps 4     # a CPU run

The flags are the reference's, plus `--device` on the seven device
subcommands (embed, build-ivf, search, serve, eval, compare-embedders,
train; default: the card; no CPU fallback). The host subcommands
(ingest-arxiv, locate-s3, parse, stacks, slogans, ingest-tex, quality)
take no `--device` and touch no device: ingest-arxiv, locate-s3 and the
tex / plastex parse methods need the network, boto3, pdflatex or plasTeX,
as in the reference. `--model-dir` loads a local HuggingFace checkpoint
of any of the four towers (qwen, gemma, BERT, deepseek: detected from its
config.json), with its tokenizer when the directory holds one and its
sentence-transformers role prompts; without it the encoder is the
hermetic one of `--embedder` (its family's tiny() config, weights from a
generator seeded 0).

`run([...])` returns each subcommand's result (the engine, the index,
the losses, the metrics, the parse stats, the slogan cost) to an
in-process caller; `main` is the console entry point.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _pkg_root() -> Path:
    """Repo root (parent of the package dir): locates the vendored data/."""
    return Path(__file__).resolve().parent.parent


def _catalog(args):
    from .ingest.catalog import Catalog

    return Catalog(args.catalog)


def _batched_encoder(args):
    """The checkpoint encoder of --model-dir (family from its config.json:
    qwen, gemma, bert or deepseek; its tokenizer when transformers loads one from
    the directory, else the hermetic one), else the hermetic encoder of
    --embedder, on --device (default: the card), in --quant mode. A
    checkpoint tokenizer that maps text to no tokens raises: some
    transformers versions build one from config.json alone, and every
    text would then embed alike."""
    import torch

    from .core.config import BertEncoderConfig, EncoderConfig, GemmaEncoderConfig
    from .encoder.batching import BatchedEncoder
    from .encoder.deepseek import DeepseekEncoderConfig
    from .encoder.tokenizer import get_tokenizer
    from .encoder.towers import tower_module
    from .utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    model_dir = getattr(args, "model_dir", None)
    if model_dir:
        from .encoder.loader import (
            detect_family, load_hf_bert_checkpoint, load_hf_checkpoint,
            load_hf_deepseek_checkpoint, load_hf_gemma_checkpoint, load_st_prompts,
        )

        loader = {"gemma": load_hf_gemma_checkpoint, "bert": load_hf_bert_checkpoint,
                  "deepseek": load_hf_deepseek_checkpoint}.get(detect_family(model_dir),
                                                                load_hf_checkpoint)
        params, cfg = loader(model_dir, device=device)
        tok = get_tokenizer(model_dir, cfg.vocab_size)
        if not tok.tokenize("every compact group"):
            raise ValueError(f"the tokenizer loaded from {model_dir} maps text to no tokens: "
                             "give the checkpoint its tokenizer files")
        prompts = load_st_prompts(model_dir)
    else:
        cls = {"gemma": GemmaEncoderConfig, "bert": BertEncoderConfig,
               "deepseek": DeepseekEncoderConfig}.get(getattr(args, "embedder", "qwen"),
                                                      EncoderConfig)
        cfg = cls.tiny()
        params = tower_module(cfg).init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device=device)
        tok = get_tokenizer(None, cfg.vocab_size)
        prompts = {}
    return BatchedEncoder(params, cfg, tokenizer=tok, prompts=prompts,
                          quant=getattr(args, "quant", "none"), device=device)


def cmd_ingest_arxiv(args):
    from .ingest.arxiv_api import MATH_CATEGORIES, upsert_arxiv
    from .ingest.citations import get_paper_citations

    cats = args.categories or MATH_CATEGORIES
    n = upsert_arxiv(
        _catalog(args),
        categories=cats,
        date_partition=args.date_partition,
        citation_lookup=get_paper_citations if args.citations else None,
    )
    print(f"upserted {n} papers")
    return n


def cmd_locate_s3(args):
    from .ingest.sources import locate_in_bundles, s3_bundle_iterator

    cat = _catalog(args)
    located = []
    for key, n in locate_in_bundles(cat, s3_bundle_iterator(args.bundle_start)):
        print(f"{key}: located {n}")
        located.append((key, n))
    return located


def cmd_parse(args):
    from .ingest.parse_driver import parse_papers

    stats = parse_papers(
        _catalog(args),
        timeout_s=args.timeout,
        limit=args.limit,
        parsing_method=args.parsing_method,
        debug=args.debugging_mode,
        verbose=True,
    )
    print(
        f"parsed={stats.parsed} failed={stats.failed} timeouts={stats.timeouts}"
        f" theorems={stats.theorems} rate={stats.parse_rate:.2%}"
    )
    return stats


def cmd_stacks(args):
    from .ingest.stacks import load_tag_map, upsert_stacks_from_json

    tag_map = load_tag_map(args.tags) if args.tags else {}
    n = upsert_stacks_from_json(_catalog(args), args.parsed, tag_map)
    print(f"ingested {n} stacks theorems")
    return n


def cmd_slogans(args):
    from .slogans import generate_slogans, get_client, load_prompt
    from .utils.tracing import get_tracer

    prompt = load_prompt(args.prompt_id, prompts_dir=args.prompts_dir)
    client = get_client(args.model)
    tracer = get_tracer("jsonl", args.trace) if args.trace else None
    cost = generate_slogans(
        _catalog(args), prompt, client, model_name=args.model,
        workers=args.workers, limit=args.limit, tracer=tracer,
    )
    print(json.dumps(cost.summary()))
    return cost


def cmd_ingest_tex(args):
    """Ingest local .tex files directly: each file becomes a synthetic
    paper with its extracted theorems."""
    from .ingest.latex.extract import extract_file

    cat = _catalog(args)
    total = 0
    for path in args.files:
        p = Path(path)
        thms = extract_file(str(p))
        pid = f"local-{p.stem}"
        cat.upsert_paper(
            {
                "paper_id": pid,
                "title": args.title or p.stem,
                "authors": args.authors or [],
                "summary": "",
                "link": f"file://{p.resolve()}",
                "last_updated": None,
                "journal_ref": None,
                "primary_category": args.category,
                "categories": [args.category],
                "citations": None,
            }
        )
        cat.replace_theorems(
            pid, [{"name": t.name, "body": t.body, "label": t.label} for t in thms], "scanner"
        )
        total += len(thms)
    print(f"ingested {total} theorems from {len(args.files)} files")
    return total


def cmd_quality(args):
    from .eval.quality import rate_slogans_quality

    report = rate_slogans_quality(_catalog(args), sample_size=args.sample)
    print(f"mean rating: {report.mean:.2f} over {len(report.ratings)} slogans")
    for sid, r in report.flagged:
        print(f"  flagged slogan_id={sid} rating={r}")
    return report


def cmd_embed(args):
    from .core.config import IndexConfig
    from .index.builder import IndexBuilder
    from .pipeline import embed_missing_slogans

    cfg = None
    if args.index_dtype:
        cfg = {
            "bfloat16": IndexConfig(dtype="bfloat16"),
            "int8": IndexConfig(dtype="int8"),
            "int8-global": IndexConfig(dtype="int8", int8_scale="global"),
            "int8-global-residual": IndexConfig(dtype="int8", int8_scale="global", residual=True),
        }[args.index_dtype]
    n = embed_missing_slogans(
        _catalog(args), _batched_encoder(args).for_role("document"), IndexBuilder(args.spool, cfg),
        embedder=args.embedder, limit=args.limit,
    )
    print(f"embedded {n} slogans")
    return n


def cmd_build_ivf(args):
    """Pack the embedding spool into an IVF index (checkpointed build: the
    k-means rounds and the assignment persist in the spool dir, so a
    killed build resumes past them), optionally calibrating nprobe
    against the recall gate."""
    from .index.builder import IndexBuilder

    b = IndexBuilder(args.spool)
    cfg = b.config
    if args.nlist:
        cfg = cfg.replace(ivf_nlist=args.nlist)
    if cfg.ivf_nlist <= 0:
        cfg = cfg.replace(ivf_nlist=max(1, b.total_rows // 256))
    b.config = cfg.replace(dtype="int8", int8_scale="global",
                           residual=bool(args.residual or cfg.residual))
    index, calib = b.finalize_ivf(
        calibrate_gate=args.calibrate_gate if args.calibrate else None,
        device=args.device,
    )
    index.save(args.out)
    msg = f"IVF index: {index.num_rows} rows, {index.slabs.shape[0]} lists -> {args.out}"
    if calib is not None:
        msg += f"; calibrated nprobe={calib[0]} (min recall {calib[1]:.4f})"
    print(msg)
    return index, calib


def cmd_search(args):
    from .pipeline import build_engine_from_catalog
    from .search.filters import SearchFilters
    from .serve.app import SearchService

    be = _batched_encoder(args)
    engine = build_engine_from_catalog(_catalog(args), be.for_role("document"), args.spool,
                                       device=be.device)
    svc = SearchService(engine, be.for_role("query"))
    rows = svc.search_and_display(
        args.query, SearchFilters(top_k=args.top_k, citation_weight=args.citation_weight))
    for r in rows:
        print(f"[{r['similarity']:.4f}] {r['theorem_name']} — {r['paper_title']}")
        if r.get("theorem_slogan"):
            print(f"    {r['theorem_slogan'][:200]}")
    return engine


def _warm(engine, be, max_batch: int) -> None:
    """Run every batch bucket and k that serving can hit through the scan,
    the over-fetch and grouped set-up, and the encoder, before traffic
    (the reference compiles its programs here; the port pays first-use
    set-up: the kernels' library, pinned host blocks, GEMM choices)."""
    import numpy as np
    import torch

    buckets = [b for b in (1, 8, 32, 128) if b <= max_batch]
    buckets.append(max_batch)
    # citation-weighted requests retrieve the rerank pool, not top_k
    cfg = engine.config
    pool_k = max(cfg.rerank_min_pool, cfg.rerank_pool_multiple * cfg.top_k)
    for b in buckets:
        for k in (cfg.top_k, min(pool_k, engine.n_valid)):
            engine.search_vectors(np.zeros((b, engine.dim), np.float32), k=k)
    engine.warm_overfetch(batch_sizes=tuple(buckets))
    if pool_k < engine.n_valid:
        engine.warm_overfetch(batch_sizes=tuple(buckets), k=pool_k)
    engine.warm_grouped(batch_sizes=tuple(buckets), k=cfg.top_k)
    if pool_k < engine.n_valid:
        engine.warm_grouped(batch_sizes=tuple(buckets), k=pool_k)
    # every batch bucket at the short width (typical queries), and the
    # saturation batch at every width (long slogans hit the wider buckets)
    for b in buckets:
        be.encode_device(["x"] * b)
    for w in be.buckets:
        be.encode_device(["x " * max(1, w - 4)] * buckets[-1])
    if be.device.type == "cuda":
        torch.cuda.synchronize(be.device)
    print(f"[warm] scan and encoder set up (batch buckets {buckets}, "
          f"k in ({cfg.top_k}, {pool_k}), widths {list(be.buckets)})")


def make_search_server(args):
    """The serving stack from a catalog: engine + encoder + (by default)
    the micro-batching scheduler with admission control, behind a
    threaded HTTP server; returns (server, scheduler or None), the server
    not yet started. With --refresh-interval a thread polls the catalog
    and makes new slogans live; the server's stop() ends it."""
    import functools
    import threading
    import traceback

    from .index.builder import IndexBuilder
    from .pipeline import build_engine_from_catalog, refresh_engine_from_catalog
    from .serve.app import SearchService
    from .serve.http_api import SearchServer
    from .serve.scheduler import BatchScheduler

    be = _batched_encoder(args)
    engine = build_engine_from_catalog(_catalog(args), be.for_role("document"), args.spool,
                                       device=be.device)
    sched = None
    if not args.no_batching:
        sched = BatchScheduler(
            engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            encode_fn=functools.partial(be.encode_device, role="query"),
            max_pending=args.max_pending or None,
        )
    svc = SearchService(engine, be.for_role("query"), scheduler=sched,
                        feedback_path=getattr(args, "feedback_path", None))
    if getattr(args, "warm", False):
        _warm(engine, be, args.max_batch)
    srv = SearchServer(svc, host=args.host, port=args.port)
    refresh_s = getattr(args, "refresh_interval", 0.0) or 0.0
    if refresh_s > 0:
        # the refreshed vectors go into the spool the engine was built
        # from, so the next restart's finalize() packs them
        spool = IndexBuilder(args.spool)
        stop = threading.Event()

        def _poll():
            # sqlite connections are bound to the thread that made them:
            # the refresh thread opens its own
            pcat = _catalog(args)
            try:
                while not stop.wait(refresh_s):
                    try:
                        n = refresh_engine_from_catalog(pcat, engine, be.for_role("document"),
                                                        builder=spool)
                        if n:
                            print(f"[refresh] {n} new docs live (corpus {engine.num_live})")
                    except Exception:  # noqa: BLE001 - keep serving
                        traceback.print_exc()
                        print("[refresh] failed; retrying at the next poll")
            finally:
                pcat.close()

        def _stop_refresh():
            stop.set()
            poller.join(timeout=60)

        poller = threading.Thread(target=_poll, daemon=True, name="catalog-refresh")
        poller.start()
        srv.on_stop.append(_stop_refresh)
    return srv, sched


def cmd_serve(args):
    """The HTTP serving daemon through the micro-batched path (POST
    /search, GET /facets, GET /health); blocks until interrupted."""
    from .utils.gc_tuning import freeze_permanent

    srv, sched = make_search_server(args)
    # the engine / encoder / metadata graph is permanent: freeze it so
    # gen-2 passes stop stalling the serving threads
    freeze_permanent()
    print(f"serving on http://{args.host}:{srv.port}  "
          f"(batching={'off' if sched is None else 'on'})")
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        if sched is not None:
            sched.shutdown()


def cmd_eval(args):
    from .eval.harness import evaluate_encoder_on_validation

    be = _batched_encoder(args)
    m = evaluate_encoder_on_validation(
        be.for_role("query"), args.validation, args.context_window,
        doc_encode_fn=be.for_role("document"),
    )
    print(json.dumps({k: round(v, 4) for k, v in m.items()}))
    return m


def cmd_compare_embedders(args):
    """Side-by-side embedder evaluation on the validation set: the named
    hermetic families, plus any --model-dir checkpoints (family detected,
    role prompts applied)."""
    from .eval.experiments import best_embedder, compare_embedders

    encoders = {}
    for fam in args.families:
        ns = argparse.Namespace(embedder=fam, model_dir=None, device=args.device)
        encoders[fam] = _batched_encoder(ns).encode
    for md in args.model_dir or []:
        be = _batched_encoder(argparse.Namespace(model_dir=md, device=args.device))
        # asymmetric role prompts: queries and documents each get their own
        encoders[md] = (be.for_role("query"), be.for_role("document"))
    if not encoders:
        raise SystemExit("nothing to compare: pass --families and/or --model-dir")
    results = compare_embedders(encoders, args.validation, args.context_window)
    cols = list(results[0].metrics) if results else []
    print("\t".join(["embedder"] + cols))
    for r in results:
        print("\t".join([r.name] + [f"{r.metrics[c]:.4f}" for c in cols]))
    print(f"best (by H@k): {best_embedder(results)}")
    return results


def cmd_train(args):
    """Contrastive fine-tuning on (query, slogan) pairs: pairs from the
    validation CSV, the catalog's latest slogans with their theorem
    bodies (--catalog) and thumbs-up feedback (thumbs-down rows as hard
    negatives), starting from the --model-dir checkpoint or the hermetic
    encoder; checkpoints with resume (the batch stream seeded past the
    consumed prefix), before/after retrieval metrics from the eval
    harness on the same validation set. Returns the step losses."""
    import sqlite3

    import numpy as np

    from .core.config import TrainConfig
    from .eval.harness import evaluate_encoder_on_validation
    from .train.checkpoint import restore_checkpoint, save_checkpoint
    from .train.contrastive import (
        TrainState, init_lora_train_state, make_lora_train_step, make_optimizer,
        make_train_step,
    )
    from .train.data import (
        batch_iterator, negatives_from_feedback, pairs_from_catalog, pairs_from_feedback,
        pairs_from_validation, tokenize_pairs,
    )

    be = _batched_encoder(args)
    cfg, tok = be.cfg, be.tokenizer
    tcfg = TrainConfig(
        batch_size=args.batch_size, seq_len=args.seq_len,
        learning_rate=args.lr, temperature=args.temperature,
        steps=args.steps, seed=args.seed,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
    )
    use_lora = tcfg.lora_rank > 0
    if use_lora:
        from .train.lora import lora_merge, lora_num_params

    pairs = pairs_from_validation(args.validation, args.context_window)
    if args.catalog:
        try:
            pairs += pairs_from_catalog(_catalog(args), limit=args.catalog_limit)
        except sqlite3.Error as e:   # the catalog is optional for train
            print(f"[train] catalog pairs skipped: {e}")
    negatives: list = []
    if args.feedback:
        pairs += pairs_from_feedback(args.feedback)
        negatives = negatives_from_feedback(args.feedback)[: args.max_negatives]
    # tune under the prompts serving applies: queries get the query
    # prefix, positives the document prefix
    q_pre = be.prompts.get("query", "")
    d_pre = be.prompts.get("document", "")
    if q_pre or d_pre:
        pairs = [(q_pre + q, d_pre + d) for q, d in pairs]
    print(f"[train] {len(pairs)} pairs")

    def eval_metrics():
        return evaluate_encoder_on_validation(
            be.for_role("query"), args.validation, args.context_window,
            doc_encode_fn=be.for_role("document"),
        )

    # start from the encoder's current params (the checkpoint or the
    # hermetic init); LoRA freezes them as the base and trains adapters only
    base_params = be.params
    if use_lora:
        state = init_lora_train_state(base_params, tcfg)
        print(f"[train] lora rank {tcfg.lora_rank} "
              f"({lora_num_params(state.params):,} trainable params; base frozen)")
    else:
        state = TrainState(params=be.params, opt_state=make_optimizer(tcfg).init(be.params), step=0)
    start = 0
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir, cfg, tcfg, template=state)
        if restored is not None:
            state = restored
            start = int(state.step)
            print(f"[train] resumed at step {start}")

    def adopt_params():
        """Point the serving encoder at the tuned weights."""
        be.params = (lora_merge(base_params, state.params, tcfg.lora_alpha)
                     if use_lora else state.params)

    if start >= tcfg.steps:
        adopt_params()
        print(f"[train] checkpoint already at step {start} >= --steps "
              f"{tcfg.steps}; nothing to do")
        if args.eval:
            print("[train] metrics:", json.dumps(
                {k: round(v, 4) for k, v in eval_metrics().items()}))
        return []

    if args.eval:
        m0 = eval_metrics()
        print("[train] before:", json.dumps({k: round(v, 4) for k, v in m0.items()}))

    arrays = tokenize_pairs(pairs, tok, tcfg.seq_len)
    neg_args = ()
    if negatives:
        neg_enc = tok([d_pre + t for _, t in negatives],
                      max_length=tcfg.seq_len, pad_to=tcfg.seq_len)
        neg_args = (np.asarray(neg_enc.input_ids, np.int32),
                    np.asarray(neg_enc.attention_mask, np.int32))
        print(f"[train] {len(negatives)} hard negatives from feedback")
    if use_lora:
        _lora_step = make_lora_train_step(cfg, tcfg)

        def step_fn(st, *batch):
            return _lora_step(st, base_params, *batch)
    else:
        step_fn = make_train_step(cfg, tcfg)
    losses = []
    saved_at = None
    # seed the stream past the consumed prefix: a resumed run must not
    # replay the batches the checkpointed run already saw
    for i, (q_ids, q_mask, p_ids, p_mask) in enumerate(
        batch_iterator(arrays, tcfg.batch_size, tcfg.steps - start, seed=tcfg.seed + start),
        start=start + 1,
    ):
        state, loss = step_fn(state, q_ids, q_mask, p_ids, p_mask, *neg_args)
        losses.append(float(loss))
        if i % max(1, args.log_every) == 0:
            print(f"[train] step {i}: loss {np.mean(losses[-args.log_every:]):.4f}")
        if args.checkpoint_dir and args.checkpoint_every and i % args.checkpoint_every == 0:
            save_checkpoint(state, args.checkpoint_dir)
            saved_at = i
    if args.checkpoint_dir and saved_at != int(state.step):
        save_checkpoint(state, args.checkpoint_dir)
    if args.checkpoint_dir:
        print(f"[train] checkpoint saved to {args.checkpoint_dir}")

    adopt_params()
    if args.eval:
        m1 = eval_metrics()
        print("[train] after:", json.dumps({k: round(v, 4) for k, v in m1.items()}))
    print(f"[train] final loss {losses[-1]:.4f} over {len(losses)} steps")
    return losses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="theoremsearch_tpu_torch")
    p.add_argument("--catalog", default="catalog.db")
    sub = p.add_subparsers(dest="cmd", required=True)
    validation = str(_pkg_root() / "data" / "validation_set.csv")

    def device_flag(s):
        s.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; 'cpu' for a CPU run)")

    def encoder_flags(s, embedder_help):
        s.add_argument("--model-dir",
                       help="local HF checkpoint dir (qwen, gemma, bert or deepseek, from its "
                            "config.json)")
        s.add_argument("--embedder", default="qwen", choices=["qwen", "gemma", "bert", "deepseek"],
                       help=embedder_help)
        device_flag(s)

    hermetic = ("hermetic model family when --model-dir is absent "
                "(with --model-dir the family is detected)")

    s = sub.add_parser("ingest-arxiv")
    s.add_argument("--categories", nargs="*")
    s.add_argument("--date-partition", default="month", choices=["year", "month", "week", "day"])
    s.add_argument("--citations", action="store_true")
    s.set_defaults(fn=cmd_ingest_arxiv)

    s = sub.add_parser("locate-s3")
    s.add_argument("--bundle-start", type=int, default=0)
    s.set_defaults(fn=cmd_locate_s3)

    s = sub.add_parser("parse")
    s.add_argument("--timeout", type=float, default=30.0)
    s.add_argument("--limit", type=int)
    s.add_argument("--parsing-method", default="scanner",
                   choices=["scanner", "flatten", "tex", "plastex"])
    s.add_argument("--debugging-mode", action="store_true")
    s.set_defaults(fn=cmd_parse)

    s = sub.add_parser("stacks")
    s.add_argument("--parsed", required=True)
    s.add_argument("--tags")
    s.set_defaults(fn=cmd_stacks)

    s = sub.add_parser("slogans")
    s.add_argument("--model", default="offline-stub")
    s.add_argument("--prompt-id", default="body-only-v1")
    s.add_argument("--prompts-dir")
    s.add_argument("--workers", type=int, default=16)
    s.add_argument("--limit", type=int)
    s.add_argument("--trace")
    s.set_defaults(fn=cmd_slogans)

    s = sub.add_parser("embed")
    encoder_flags(s, "embedder alias: tags the catalog rows and picks the hermetic "
                     "architecture when --model-dir is absent")
    s.add_argument("--spool", default="./spool")
    s.add_argument("--limit", type=int)
    s.add_argument(
        "--index-dtype", default=None,
        choices=["bfloat16", "int8", "int8-global", "int8-global-residual"],
        help="index layout the spool will finalize into (fixed at spool creation): "
             "int8-global unlocks the speed path; int8-global-residual adds the "
             "2-bytes/dim two-level rescore (capacity mode)",
    )
    s.set_defaults(fn=cmd_embed)

    s = sub.add_parser("build-ivf")
    s.add_argument("--spool", default="./spool")
    s.add_argument("--out", default="./ivf_index")
    s.add_argument("--nlist", type=int, default=0)
    s.add_argument("--residual", action="store_true",
                   help="2-bytes/dim capacity mode: rescore from two-level int8 residual "
                        "codes instead of a bf16 copy")
    s.add_argument("--calibrate", action="store_true",
                   help="pick the smallest nprobe holding the recall gate")
    s.add_argument("--calibrate-gate", type=float, default=0.99)
    device_flag(s)
    s.set_defaults(fn=cmd_build_ivf)

    s = sub.add_parser("search")
    s.add_argument("query")
    s.add_argument("--spool", default="./spool")
    encoder_flags(s, hermetic)
    s.add_argument("--top-k", type=int, default=10)
    s.add_argument("--citation-weight", type=float, default=0.0)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("serve")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--spool", default="./spool")
    encoder_flags(s, hermetic)
    s.add_argument("--no-batching", action="store_true",
                   help="serve without the micro-batching scheduler")
    s.add_argument("--max-batch", type=int, default=256)
    s.add_argument("--max-wait-ms", type=float, default=8.0)
    s.add_argument("--max-pending", type=int, default=2048,
                   help="admission-control bound (0 = unbounded); beyond it requests get HTTP 429")
    s.add_argument("--feedback-path", default="feedback.jsonl",
                   help="JSONL file for POST /feedback votes (the InfoNCE training signal); "
                        "empty string disables")
    s.add_argument("--refresh-interval", type=float, default=0.0,
                   help="poll the catalog every N seconds for new slogans and add them to "
                        "the live index (0 = off)")
    s.add_argument("--warm", action="store_true",
                   help="run every batch bucket through the scan and the encoder before "
                        "accepting traffic")
    s.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 = w8a8 projection matmuls in the encoder (qwen and gemma "
                        "families; the whole-layer kernels B3 and B4 on the card)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("eval")
    s.add_argument("--validation", default=validation,
                   help="labeled eval CSV (default: the vendored copy in data/)")
    s.add_argument("--context-window", default="body-and-summary-v1")
    encoder_flags(s, hermetic)
    s.set_defaults(fn=cmd_eval)

    s = sub.add_parser("train")
    s.add_argument("--validation", default=validation)
    s.add_argument("--context-window", default="body-and-summary-v1")
    s.add_argument("--catalog", default=None,
                   help="also pair latest slogans with theorem bodies from this catalog")
    s.add_argument("--catalog-limit", type=int, default=None)
    s.add_argument("--feedback", default=None,
                   help="feedback JSONL; thumbs-up rows become positives, "
                        "thumbs-down rows hard negatives")
    s.add_argument("--max-negatives", type=int, default=32)
    encoder_flags(s, hermetic)
    s.add_argument("--steps", type=int, default=100)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--seq-len", type=int, default=64)
    s.add_argument("--lr", type=float, default=1e-4)
    s.add_argument("--temperature", type=float, default=0.05)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--checkpoint-every", type=int, default=50)
    s.add_argument("--log-every", type=int, default=10)
    s.add_argument("--eval", action="store_true",
                   help="report validation metrics before and after")
    s.add_argument("--lora-rank", type=int, default=0,
                   help="> 0 = parameter-efficient fine-tuning: freeze the base encoder, "
                        "train rank-r deltas on the q/v projections, merge for serving "
                        "(0 = full fine-tune)")
    s.add_argument("--lora-alpha", type=float, default=16.0)
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("compare-embedders")
    s.add_argument("--validation", default=validation)
    s.add_argument("--context-window", default="body-and-summary-v1")
    s.add_argument("--families", nargs="*", default=["qwen", "gemma", "bert"],
                   choices=["qwen", "gemma", "bert"], help="hermetic families to compare")
    s.add_argument("--model-dir", action="append",
                   help="also compare a checkpoint dir (repeatable)")
    device_flag(s)
    s.set_defaults(fn=cmd_compare_embedders)

    s = sub.add_parser("ingest-tex")
    s.add_argument("files", nargs="+")
    s.add_argument("--title")
    s.add_argument("--authors", nargs="*")
    s.add_argument("--category", default="math.GM")
    s.set_defaults(fn=cmd_ingest_tex)

    s = sub.add_parser("quality")
    s.add_argument("--sample", type=int, default=20)
    s.set_defaults(fn=cmd_quality)
    return p


def run(argv=None):
    """Parse `argv` and run its subcommand; returns the subcommand's
    result (the engine, the IVF index and its calibration, the losses,
    the metrics, the parse stats, the slogan cost) to an in-process
    caller."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    """The console entry point: run, exit 0."""
    run(argv)
    return 0


if __name__ == "__main__":
    main()
