"""LoRA adapters for contrastive encoder fine-tuning (port of
theoremsearch_tpu/train/lora.py).

Freeze the base encoder, train low-rank deltas on projection matrices,
merge for serving:

  w_eff = w + (alpha / rank) * A @ B,  A: (in, r) ~ N(0, 1/in),  B: (r, out) = 0

so at step 0 the merged encoder is the base encoder. Gradients flow only
to the A/B leaves. A `torch.Generator` draws other numbers than
`jax.random` from the same seed, so the tests carry JAX's adapters over
(`lora_from_jax`) rather than match its draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder.model import Params, params_from_jax
from ..encoder.sharding import ShardedTensor
from ..utils.device import tf32_off

DEFAULT_TARGETS = ("wq", "wv")

LoraParams = list  # per-layer {target: {"a": (in, r) f32, "b": (r, out) f32}}


def lora_init(
    params: Params,
    generator: torch.Generator,
    rank: int,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
) -> LoraParams:
    """Zero-effect adapters (B = 0) for `targets` of every layer, on the
    params' device; A is drawn from `generator` (on any device)."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    layer0 = params["layers"][0]
    for t in targets:
        if t not in layer0 or getattr(layer0[t], "ndim", 0) != 2:
            raise ValueError(
                f"lora target {t!r} is not a 2-D matrix of this encoder "
                f"family (layer keys: {sorted(layer0)})"
            )
    dev = params["embed"].device
    out = []
    for layer in params["layers"]:
        entry = {}
        for t in targets:
            in_dim, out_dim = layer[t].shape
            a = torch.randn((in_dim, rank), generator=generator, device=generator.device)
            entry[t] = {
                "a": (a / np.sqrt(in_dim)).to(device=dev, dtype=torch.float32),
                "b": torch.zeros((rank, out_dim), dtype=torch.float32, device=dev),
            }
        out.append(entry)
    return out


def lora_from_jax(np_lora, device=None) -> LoraParams:
    """JAX adapters as numpy leaves (`jax.device_get(lora)`) -> the port's,
    on `device` (default: the card; pass "cpu" for a CPU run)."""
    return params_from_jax(np_lora, device)


def lora_merge(params: Params, lora: LoraParams, alpha: float) -> Params:
    """Effective params: base + (alpha/rank) * A@B on each adapted matrix,
    in the base dtype (the f32 product with TF32 off). A sharded base
    matrix (`encoder/sharding.py`) gets the delta split by its own rule,
    each local block added to its piece on that piece's device
    (`ShardedTensor.blocks`: on a row split over processes the delta's
    gradient is summed over the row)."""
    new_layers = []
    for layer, entry in zip(params["layers"], lora):
        nl = dict(layer)
        for t, ab in entry.items():
            rank = ab["a"].shape[1]
            with tf32_off():
                delta = (ab["a"] @ ab["b"]) * (alpha / rank)
            w = layer[t]
            if isinstance(w, ShardedTensor):
                nl[t] = w.with_pieces([(p.float() + d.to(p.device)).to(p.dtype)
                                       for p, d in zip(w.pieces, w.blocks(delta))])
            else:
                nl[t] = (w.float() + delta).to(w.dtype)
        new_layers.append(nl)
    return {**params, "layers": new_layers}


def lora_num_params(lora: LoraParams) -> int:
    return sum(ab[k].numel() for entry in lora for ab in entry.values() for k in ab)
