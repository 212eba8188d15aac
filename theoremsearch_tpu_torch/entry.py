"""Entry point of the port (counterpart of `__graft_entry__.entry`): the
pooled encoder forward with example inputs.

    fn, args = entry()              # on the card
    out = fn(*args)                 # (8, 1024) f32, L2-normalized

On the card: the Qwen3-Embedding-0.6B-class `EncoderConfig(max_seq_len=128)`
with random weights, its attention through kernel B2. With device="cpu":
the tiny config on the plain path. The multi-device dry run of the
reference (`dryrun_multichip`) waits for ROADMAP A.10.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core.config import EncoderConfig
from .encoder.model import encode_pooled, init_params
from .encoder.tokenizer import SimpleTokenizer
from .utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): fn(params, input_ids, attention_mask) -> (8, D)."""
    device = resolve_device(device)
    cfg = EncoderConfig(max_seq_len=128) if device.type == "cuda" else EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    enc = tok(["classification of finite simple groups", "bound the chromatic number"],
              pad_to=min(64, cfg.max_seq_len))
    # a batch of 8: the two texts four times
    ids = torch.from_numpy(np.concatenate([enc.input_ids] * 4)).to(device)
    mask = torch.from_numpy(np.concatenate([enc.attention_mask] * 4)).to(device)
    return functools.partial(encode_pooled, cfg=cfg, fused="on"), (params, ids, mask)
