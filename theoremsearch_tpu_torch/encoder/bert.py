"""BERT-base-class text encoder on tensors (port of
theoremsearch_tpu/encoder/bert.py).

The classic post-LayerNorm bidirectional transformer: word + learned
absolute position + token-type embeddings, LayerNorm; every projection
with a bias; attention scaled by head_dim^-1/2 under a padding-only mask;
LayerNorm(residual + sublayer) after each sublayer; Linear -> GELU (exact,
or tanh for hidden_act "gelu_new") -> Linear; mean pooling over valid
tokens and L2 normalize. bf16 params and activations with f32 LayerNorm
and softmax, as the reference.

The reference runs BERT on its XLA composition (its `encode_pooled`
drops `fused`); the port runs the attention core through a kernel of
BERT's own (`kernels/attention_bert.py`: head_dim 64, S <= 512, bf16, no
gradient recorded; `_core`), with the q/k/v bias adds folded in, and
keeps the composition (`_attention_core`) for fused="off", for training
and for the shapes the kernel does not take.

Tensor parallelism as the qwen tower's (`encoder/model.py`: one layer
loop on the params' placement), by the reference's rules: q/k/v and w_in
column-sharded with their biases, wo and w_out row-sharded (their biases
added once after the reduction), the word embedding vocab-sharded, the
position and type tables replicated. With the kernel core each shard's
q/k/v bias blocks are added inside it, as on one device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import BertEncoderConfig
from ..kernels.attention_bert import HEAD_DIM, MAX_S, bert_attention, bert_attention_plain
from ..kernels.layer_int8 import gelu_tanh
from ..utils.device import resolve_device, tf32_off
from .model import _DTYPES, PooledEncoder, params_from_jax
from .sharding import place_params, placement

Params = dict[str, Any]

__all__ = ["init_params", "params_from_jax", "forward", "encode_pooled", "param_sharding_rules",
           "shard_params", "BertEncoder"]

_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def init_params(cfg: BertEncoderConfig, generator: torch.Generator, device=None) -> Params:
    """Random init from an explicit generator on `device` (default: the
    card; "cpu" for a CPU run): N(0, 0.02^2) matrices and embeddings
    (BERT's initializer_range), zero biases, unit LayerNorm gains."""
    device = resolve_device(device)
    pdtype = _DTYPES[cfg.param_dtype]
    h, i = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(pdtype)

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "wq": normal(h, h), "bq": const(h, 0.0), "wk": normal(h, h), "bk": const(h, 0.0),
            "wv": normal(h, h), "bv": const(h, 0.0), "wo": normal(h, h), "bo": const(h, 0.0),
            "attn_ln_g": const(h, 1.0), "attn_ln_b": const(h, 0.0),
            "w_in": normal(h, i), "b_in": const(i, 0.0), "w_out": normal(i, h),
            "b_out": const(h, 0.0), "mlp_ln_g": const(h, 1.0), "mlp_ln_b": const(h, 0.0),
        })
    return {
        "embed": normal(cfg.vocab_size, h), "pos_embed": normal(cfg.max_seq_len, h),
        "type_embed": normal(cfg.type_vocab_size, h),
        "embed_ln_g": const(h, 1.0), "embed_ln_b": const(h, 0.0), "layers": layers,
    }


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False)'s form: 0.5 x erfc(-x sqrt(1/2))."""
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    nh: int, dh: int) -> torch.Tensor:
    """The masked softmax attention of `nh` heads of `dh` on projected
    (B, S, nh * dh) q/k/v; (B, S, nh * dh) pre-wo."""
    b, s, _ = q.shape
    dtype = q.dtype
    q, k, v = (t.reshape(b, s, nh, dh) for t in (q, k, v))
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(dh)
        logits = torch.where(mask[:, None, None, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype).reshape(b, s, nh * dh)


_QKV = (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))


def _core(fused: str, cfg: BertEncoderConfig, s: int):
    """The attention core's kernel form for a forward at width `s`, or None
    for the composition: `bert_attention` (the kernel on the card, its plain
    version for CPU tensors) for fused="on", `bert_attention_plain` for
    "plain", where the kernel takes the shapes: head_dim 64, bf16
    activations, S <= 512 and no gradient recorded (the kernel has no
    backward; training keeps the composition)."""
    if fused not in ("on", "plain", "off"):
        raise ValueError(f"fused must be 'on', 'plain' or 'off', got {fused!r}")
    if (fused == "off" or cfg.hidden_size // cfg.num_heads != HEAD_DIM or s > MAX_S
            or _DTYPES[cfg.dtype] != torch.bfloat16 or torch.is_grad_enabled()):
        return None
    return bert_attention_plain if fused == "plain" else bert_attention


def forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: BertEncoderConfig, fused: str = "on") -> torch.Tensor:
    """Hidden states (B, S, H) after the last layer. Position ids are
    arange(S) whatever the padding; single-segment inputs (type 0).

    fused: "on" = the attention core through BERT's kernel where `_core`
    takes the shapes (its plain version for CPU tensors); "plain" = the
    plain version there; "off" = the reference's composition throughout.
    The kernel forms write 0 on padded query rows.

    On sharded params (`shard_params`) the same loop runs on their
    shards' devices (`sharding.TP`): the LayerNorms and residuals on the
    first, the biased projections and the GELU on each shard's blocks,
    the heads local or gathered."""
    s = input_ids.shape[1]
    core = _core(fused, cfg, s)
    tp = placement(params["embed"])
    ids, am = input_ids.to(tp.first), attention_mask.to(tp.first)
    dtype = _DTYPES[cfg.dtype]
    eps = cfg.layer_norm_eps
    mask = am.bool()
    x = (tp.embed(params["embed"], ids) + params["pos_embed"][:s][None]
         + params["type_embed"][0][None, None]).to(dtype)
    x = _layer_norm(x, params["embed_ln_g"], params["embed_ln_b"], eps)
    act = gelu_tanh if cfg.hidden_act == "gelu_new" else _gelu_exact
    dh = cfg.hidden_size // cfg.num_heads
    on = tp.on_devices(mask, am)

    def attend(q, k, v, dev, div, *bias):
        mask_d, am_d = on[dev]
        if core is None:
            return _attention_core(q, k, v, mask_d, cfg.num_heads // div, dh)
        return core(q, k, v, am_d, num_heads=cfg.num_heads // div, bias=bias)

    fold = core is not None     # the kernel core adds the q/k/v biases itself
    for layer in params["layers"]:
        xs = tp.bcast(x)
        qkv = [tp.col(xs, layer[w], None if fold else layer[b]) for w, b in _QKV]
        attn = tp.attention(*qkv, cfg.num_heads, attend, *(layer[b] for _, b in _QKV if fold))
        attn = tp.row(attn, layer["wo"]) + layer["bo"].to(dtype)
        x = _layer_norm(x + attn, layer["attn_ln_g"], layer["attn_ln_b"], eps)
        ff = [act(h.float()).to(dtype) for h in tp.col(tp.bcast(x), layer["w_in"], layer["b_in"])]
        ff = tp.row(ff, layer["w_out"]) + layer["b_out"].to(dtype)
        x = _layer_norm(x + ff, layer["mlp_ln_g"], layer["mlp_ln_b"], eps)
    return x


def encode_pooled(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  cfg: BertEncoderConfig, fused: str = "on") -> torch.Tensor:
    """Mean pooling over valid tokens and L2 normalize, (B, D) f32; `fused`
    as `forward`'s."""
    hidden = forward(params, input_ids, attention_mask, cfg, fused=fused)
    m = attention_mask[:, :, None].float()
    pooled = (hidden.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


# ---------------------------------------------------------------------------
# sharding rules (dp over 'data', tp over 'shard')
# ---------------------------------------------------------------------------


def param_sharding_rules(mesh, tp_axis: str = "shard") -> Params:
    """The reference's spec tree (bert.py:param_sharding_rules)."""
    t = tp_axis
    layer_rules = {
        "wq": (None, t), "bq": (t,),
        "wk": (None, t), "bk": (t,),
        "wv": (None, t), "bv": (t,),
        "wo": (t, None), "bo": (None,),
        "attn_ln_g": (None,), "attn_ln_b": (None,),
        "w_in": (None, t), "b_in": (t,),
        "w_out": (t, None), "b_out": (None,),
        "mlp_ln_g": (None,), "mlp_ln_b": (None,),
    }
    return {
        "embed": (t, None),
        "pos_embed": (None, None),
        "type_embed": (None, None),
        "embed_ln_g": (None,),
        "embed_ln_b": (None,),
        "layers": layer_rules,
    }


def shard_params(params: Params, mesh, tp_axis: str = "shard") -> Params:
    """Params placed on the mesh by the tp rules (fresh copies)."""
    return place_params(params, param_sharding_rules(mesh, tp_axis), mesh)


class BertEncoder(PooledEncoder):
    """The BERT tower's wrapper (default config `BertEncoderConfig()`)."""

    default_config = BertEncoderConfig
