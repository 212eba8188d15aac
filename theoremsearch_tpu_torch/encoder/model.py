"""Qwen3-Embedding-class text encoder on tensors (port of
theoremsearch_tpu/encoder/model.py, bf16 serving forward).

token embedding -> N x (RMSNorm -> grouped-query attention with per-head
q/k RMSNorm and RoPE -> RMSNorm -> SwiGLU MLP) -> final RMSNorm ->
last-token pooling -> L2 normalize.

Params are a plain dict of tensors with the reference's pytree layout
and names, so `params_from_jax` carries JAX weights over as numpy. The
attention block goes through the fused kernel
(`kernels/attention.py`, CUDA on the card) exactly where the reference
takes its fused Pallas kernel (`_fused_ok`: head_dim 128, S <= 128);
longer buckets run the plain composition, as in the reference. The
projections, the MLP and the embedding gather stay torch ops, as the
reference left them to XLA. The int8 encoder mode is not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import EncoderConfig
from ..kernels.attention import (
    fused_qknorm_rope_attention,
    fused_qknorm_rope_attention_plain,
)
from ..utils.device import tf32_off

Params = dict[str, Any]

_BF16 = torch.bfloat16
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: EncoderConfig, generator: torch.Generator, device="cpu") -> Params:
    """Random init from an explicit generator, which must live on
    `device`: unit norms and N(0, 0.02^2) weights, Qwen3's published
    initializer_range. (The reference draws dense weights N(0, 1/in);
    tests carry JAX weights over rather than match its draws.)"""
    pdtype = _DTYPES[cfg.param_dtype]
    qkv_dim = cfg.head_dim * cfg.num_heads
    kv_dim = cfg.head_dim * cfg.num_kv_heads

    def dense(i, o):
        w = torch.randn((i, o), generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(pdtype)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": ones(cfg.hidden_size),
            "wq": dense(cfg.hidden_size, qkv_dim),
            "wk": dense(cfg.hidden_size, kv_dim),
            "wv": dense(cfg.hidden_size, kv_dim),
            "wo": dense(qkv_dim, cfg.hidden_size),
            "q_norm": ones(cfg.head_dim),
            "k_norm": ones(cfg.head_dim),
            "mlp_norm": ones(cfg.hidden_size),
            "w_gate": dense(cfg.hidden_size, cfg.intermediate_size),
            "w_up": dense(cfg.hidden_size, cfg.intermediate_size),
            "w_down": dense(cfg.intermediate_size, cfg.hidden_size),
        })
    embed = torch.randn((cfg.vocab_size, cfg.hidden_size), generator=generator,
                        device=device, dtype=torch.float32) * 0.02
    return {"embed": embed.to(pdtype), "final_norm": ones(cfg.hidden_size), "layers": layers}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: carry the bit pattern
        return torch.from_numpy(a.view(np.int16)).view(_BF16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: Params, device="cpu") -> Params:
    """JAX params (a pytree of numpy arrays, e.g. jax.device_get(params))
    -> torch params with the same structure and dtypes."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_jax(v, device) for v in np_params]
    return _to_tensor(np_params, device)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _rope_tables(positions: torch.Tensor, dh: int, theta: float):
    """cos/sin tables (B, S, half) f32, computed once per forward."""
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / torch.pow(base, exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention_math(layer, q, k, v, mask, rope_cs, cfg: EncoderConfig) -> torch.Tensor:
    """The reference's XLA composition: per-head QK-RMSNorm -> RoPE ->
    GQA repeat -> masked softmax -> PV. (B, S, H*Dh) pre-wo."""
    b, s, _ = q.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_cs
    dtype = q.dtype
    q = _rope(_rms_norm(q.view(b, s, h, dh), layer["q_norm"], cfg.rms_norm_eps), cos, sin)
    k = _rope(_rms_norm(k.view(b, s, hk, dh), layer["k_norm"], cfg.rms_norm_eps), cos, sin)
    rep = h // hk
    k = k.repeat_interleave(rep, dim=2)
    v = v.view(b, s, hk, dh).repeat_interleave(rep, dim=2)
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / np.sqrt(dh))
        causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        valid = mask[:, None, None, :] & causal[None, None]
        logits = torch.where(valid, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype).reshape(b, s, h * dh)


def _attention(layer, x, mask, rope_cs, cfg) -> torch.Tensor:
    out = _attention_math(layer, x @ layer["wq"], x @ layer["wk"], x @ layer["wv"],
                          mask, rope_cs, cfg)
    return out @ layer["wo"]


def _fused_ok(cfg: EncoderConfig, s: int, b: int) -> bool:
    """The reference's dispatch rule for its fused kernel: 128-lane
    head_dim, S <= 128, a batch divisible by its packing factor."""
    bb = max(1, 128 // s)
    return (
        cfg.head_dim == 128
        and s <= 128
        and b % bb == 0
        and cfg.num_heads % cfg.num_kv_heads == 0
    )


def _attention_fused(layer, x, attention_mask, rope_cs, cfg, plain: bool) -> torch.Tensor:
    cos, sin = rope_cs
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, causal=True)
    args = ((x @ layer["wq"]).contiguous(), (x @ layer["wk"]).contiguous(),
            (x @ layer["wv"]).contiguous(), layer["q_norm"], layer["k_norm"],
            cos, sin, attention_mask.to(torch.int32))
    if plain:
        attn = fused_qknorm_rope_attention_plain(*args, scale=1.0 / np.sqrt(cfg.head_dim), **kw)
    else:
        attn = fused_qknorm_rope_attention(*args, **kw)
    return attn.to(x.dtype) @ layer["wo"]


def _mlp(layer, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu((x @ layer["w_gate"]).float()).to(x.dtype)
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


def forward(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: EncoderConfig, fused: str = "on",
) -> torch.Tensor:
    """Hidden states (B, S, H) after the final norm.

    fused: "on" = the fused attention block where the shapes qualify (the
    CUDA kernel for CUDA tensors); "plain" = the same block through the
    kernel's plain version, with the kernel's casts (the counterpart of
    the reference's fused="interpret"); "off" = the reference's plain
    composition throughout."""
    if fused not in ("on", "plain", "off"):
        raise ValueError(f"fused must be 'on', 'plain' or 'off', got {fused!r}")
    x = params["embed"][input_ids.long()].to(_DTYPES[cfg.dtype])
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)
    mask = attention_mask.bool()
    rope_cs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    b, s = input_ids.shape
    use_fused = fused != "off" and _fused_ok(cfg, s, b)
    for layer in params["layers"]:
        xa = _rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        if use_fused:
            x = x + _attention_fused(layer, xa, attention_mask, rope_cs, cfg, fused == "plain")
        else:
            x = x + _attention(layer, xa, mask, rope_cs, cfg)
        x = x + _mlp(layer, _rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))
    return _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def encode_pooled(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: EncoderConfig, fused: str = "on",
) -> torch.Tensor:
    """Pooled, L2-normalized embeddings (B, D) f32: the last non-padding
    (EOS) position for qwen, or the masked mean."""
    hidden = forward(params, input_ids, attention_mask, cfg, fused=fused)
    if cfg.pooling == "last_token":
        idx = torch.clamp(attention_mask.to(torch.int64).sum(dim=1) - 1, min=0)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    elif cfg.pooling == "mean":
        m = attention_mask[:, :, None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1)
    else:
        raise ValueError(f"unknown pooling {cfg.pooling}")
    pooled = pooled.float()
    if cfg.embedding_dim != pooled.shape[-1]:
        pooled = pooled[:, : cfg.embedding_dim]
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled
