"""Command line of the port (counterpart of theoremsearch_tpu/cli.py).

    python -m theoremsearch_tpu_torch train --steps 100 --checkpoint-dir ckpt --eval
    python -m theoremsearch_tpu_torch train --device cpu --steps 4   # a CPU run
    python -m theoremsearch_tpu_torch train --embedder gemma --steps 4

Only the `train` subcommand is ported; the others come with ROADMAP A.1.
Its flags are the reference's, plus `--device` (default: the card). The
encoder is the hermetic one of `--embedder` (qwen, gemma or bert): the
family's `tiny()` config with seeded random weights. `--catalog` and
`--model-dir` exit non-zero, naming the ROADMAP item they wait for.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _pkg_root() -> Path:
    """Repo root (parent of the package dir): locates the vendored data/."""
    return Path(__file__).resolve().parent.parent


def _refuse_unported(args) -> None:
    if getattr(args, "model_dir", None):
        raise SystemExit("--model-dir checkpoints are not ported yet (ROADMAP A.1)")
    if getattr(args, "catalog", None):
        raise SystemExit("--catalog pairs are not ported yet (ROADMAP A.1)")


def _batched_encoder(args):
    """The hermetic encoder of --embedder (its family's tiny() config,
    weights from a generator seeded 0) on --device."""
    import torch

    from .core.config import BertEncoderConfig, EncoderConfig, GemmaEncoderConfig
    from .encoder.batching import BatchedEncoder
    from .encoder.families import family_module
    from .encoder.tokenizer import get_tokenizer
    from .utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    cls = {"gemma": GemmaEncoderConfig, "bert": BertEncoderConfig}.get(
        getattr(args, "embedder", "qwen"), EncoderConfig)
    cfg = cls.tiny()
    params = family_module(cfg).init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                            device=device)
    tok = get_tokenizer(None, cfg.vocab_size)
    return BatchedEncoder(params, cfg, tokenizer=tok, prompts={}, device=device)


def cmd_train(args):
    """Contrastive fine-tuning on (query, slogan) pairs: pairs from the
    validation CSV and thumbs-up feedback (thumbs-down rows as hard
    negatives), checkpoints with resume (the batch stream seeded past the
    consumed prefix), before/after retrieval metrics from the eval
    harness on the same validation set."""
    import numpy as np

    from .core.config import TrainConfig
    from .eval.harness import evaluate_encoder_on_validation
    from .train.checkpoint import restore_checkpoint, save_checkpoint
    from .train.contrastive import (
        TrainState,
        init_lora_train_state,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
    )
    from .train.data import (
        batch_iterator,
        negatives_from_feedback,
        pairs_from_feedback,
        pairs_from_validation,
        tokenize_pairs,
    )

    _refuse_unported(args)
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
    negatives: list = []
    if args.feedback:
        pairs += pairs_from_feedback(args.feedback)
        negatives = negatives_from_feedback(args.feedback)[: args.max_negatives]
    # tune under the prompts serving applies (none for the hermetic encoder)
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

    # start from the encoder's current params; LoRA freezes them as the
    # base and trains adapters only
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
        return

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="theoremsearch_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("train")
    s.add_argument("--validation", default=str(_pkg_root() / "data" / "validation_set.csv"))
    s.add_argument("--context-window", default="body-and-summary-v1")
    s.add_argument("--catalog", default=None,
                   help="also pair latest slogans with theorem bodies from this catalog "
                        "(not ported yet: ROADMAP A.1)")
    s.add_argument("--catalog-limit", type=int, default=None)
    s.add_argument("--feedback", default=None,
                   help="feedback JSONL; thumbs-up rows become positives, "
                        "thumbs-down rows hard negatives")
    s.add_argument("--max-negatives", type=int, default=32)
    s.add_argument("--model-dir", help="not ported yet (ROADMAP A.1)")
    s.add_argument("--embedder", default="qwen", choices=["qwen", "gemma", "bert"],
                   help="hermetic model family (its tiny() config, seeded random weights)")
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
    s.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card; 'cpu' for a CPU run)")
    s.set_defaults(fn=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
