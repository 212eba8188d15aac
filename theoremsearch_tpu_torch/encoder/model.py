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
reference left them to XLA.

int8 (w8a8) serving mode: `quantize_params_int8` gives per-layer int8
weights with per-output-column scales; `forward(qlayers=...)` runs every
projection as an exact int8 product with per-token activation scales.
With `fused_layers=True` each sub-block whose shapes qualify
(`_fused_layer_ok`) is one whole-layer call (`kernels/layer_int8.py`,
kernels B3 and B4 on the card); the rest run the int8 op-chain.

Tensor parallelism: `shard_params` places the params by the reference's
rules (`param_sharding_rules`: q/k/v and gate/up column-sharded, wo and
w_down row-sharded, the embedding vocab-sharded; `encoder/sharding.py`)
and `forward` on such params runs `_forward_tp`: each shard multiplies
the replicated activation by its column blocks, runs the attention core
on its own heads where the kv heads divide over the shards (kernel B2
forward and B7 backward once a shard), else on all heads gathered on the
first device, and the row-sharded products are summed there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import EncoderConfig
from ..kernels.attention import QKNormRopeAttention
from ..kernels.layer_int8 import (
    dequant,
    fused_attn_int8_layer,
    fused_attn_int8_layer_plain,
    fused_layer_shapes_ok,
    fused_mlp_int8_layer,
    fused_mlp_int8_layer_plain,
    i8_matmul,
    quant_rows_plain,
    rmsnorm_quant_plain,
)
from ..utils.device import resolve_device, tf32_off
from .sharding import TP, is_sharded, place_params

Params = dict[str, Any]

_BF16 = torch.bfloat16
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: EncoderConfig, generator: torch.Generator, device=None) -> Params:
    """Random init from an explicit generator, which must live on
    `device` (default: the card; pass "cpu" for a CPU run): unit norms
    and N(0, 0.02^2) weights, Qwen3's published initializer_range. (The
    reference draws dense weights N(0, 1/in); tests carry JAX weights
    over rather than match its draws.)"""
    device = resolve_device(device)
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


def params_from_jax(np_params: Params, device=None) -> Params:
    """JAX params (a pytree of numpy arrays, e.g. jax.device_get(params))
    -> torch params with the same structure and dtypes, on `device`
    (default: the card; pass "cpu" for a CPU run)."""
    device = resolve_device(device)
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


def _attention_core(layer, q, k, v, attention_mask, rope_cs, cfg, plain: bool) -> torch.Tensor:
    """The fused attention core on projected q/k/v, through the autograd
    Function: kernel B2 forward and kernel B7 backward, or their plain
    versions for plain=True or CPU tensors. (B, S, H*Dh) pre-wo. Under
    inference mode it is the forward alone."""
    return QKNormRopeAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), layer["q_norm"], layer["k_norm"],
        rope_cs[0], rope_cs[1], attention_mask.to(torch.int32),
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_norm_eps, True,
        1.0 / np.sqrt(cfg.head_dim), plain)


def _attention_fused(layer, x, attention_mask, rope_cs, cfg, plain: bool) -> torch.Tensor:
    attn = _attention_core(layer, x @ layer["wq"], x @ layer["wk"], x @ layer["wv"],
                           attention_mask, rope_cs, cfg, plain)
    return attn.to(x.dtype) @ layer["wo"]


def _mlp(layer, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu((x @ layer["w_gate"]).float()).to(x.dtype)
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


# ---------------------------------------------------------------------------
# int8 (w8a8) inference quantization
# ---------------------------------------------------------------------------
# Static per-output-column weight scales, dynamic per-token activation
# scales, for the seven projection matrices; norms, RoPE, softmax and
# the attention core stay bf16/f32.

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quant_weight(w: torch.Tensor) -> dict:
    """(in, out) -> int8 codes + f32 per-output-column scales, bit-equal
    to the reference's jitted form (max / 127 as max * f32(1/127))."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=0) * (1.0 / 127.0), min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params_int8(params: Params) -> list[dict]:
    """Per-layer int8 weights for the seven projection matrices, on the
    params' device. Derived state: the bf16 params stay authoritative
    (embedding gather, norms and pooling read them)."""
    return [{k: _quant_weight(layer[k]) for k in _QUANT_KEYS} for layer in params["layers"]]


def _quant_act(x: torch.Tensor):
    """(..., d) -> int8 rows + f32 per-row (per-token) scales."""
    return quant_rows_plain(x)


def _rmsnorm_quant_act(x: torch.Tensor, w: torch.Tensor, eps: float, w_offset: float = 0.0):
    """Fused RMSNorm -> per-token int8 quant, never forming the normed
    tensor (`kernels/layer_int8.py:rmsnorm_quant_plain`); `w_offset=1.0`
    expresses gemma's (1 + w) norm form."""
    return rmsnorm_quant_plain(x, w.float() + w_offset, eps)


def _q_matmul(xq: torch.Tensor, sx: torch.Tensor, w: dict, out_dtype) -> torch.Tensor:
    """Exact int8 x int8 product, dequantized via the two scales."""
    return dequant(i8_matmul(xq, w["q"]), sx, w["s"]).to(out_dtype)


def _attention_int8(layer, lq, x, attention_mask, rope_cs, cfg: EncoderConfig,
                    use_fused: bool, plain: bool) -> torch.Tensor:
    """Attention block with int8 q/k/v/o projections; `x` is PRE-norm
    (the attn RMSNorm fuses into the shared activation quant). The core
    is the fused kernel (or its plain version) where `use_fused`, else
    the reference composition."""
    xq, sx = _rmsnorm_quant_act(x, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = (_q_matmul(xq, sx, lq[n], x.dtype) for n in ("wq", "wk", "wv"))
    if use_fused:
        attn = _attention_core(layer, q, k, v, attention_mask, rope_cs, cfg, plain)
    else:
        attn = _attention_math(layer, q, k, v, attention_mask.bool(), rope_cs, cfg)
    aq, sa = _quant_act(attn.to(x.dtype))
    return _q_matmul(aq, sa, lq["wo"], x.dtype)


def _mlp_int8(layer, lq, x: torch.Tensor, eps: float) -> torch.Tensor:
    """SwiGLU MLP with int8 products; `x` is PRE-norm."""
    xq, sx = _rmsnorm_quant_act(x, layer["mlp_norm"], eps)
    gate = _q_matmul(xq, sx, lq["w_gate"], torch.float32)
    up = _q_matmul(xq, sx, lq["w_up"], torch.float32)
    h = (F.silu(gate) * up).to(x.dtype)
    hq, sh = _quant_act(h)
    return _q_matmul(hq, sh, lq["w_down"], x.dtype)


def _fused_layer_ok(cfg: EncoderConfig, s: int, b: int) -> bool:
    """The reference's rule for its whole-layer int8 kernels: the fused
    attention rule (`_fused_ok`) and 128-aligned dims within its weight
    budget (`kernels/layer_int8.py:fused_layer_shapes_ok`)."""
    return _fused_ok(cfg, s, b) and fused_layer_shapes_ok(
        cfg.hidden_size, cfg.intermediate_size,
        cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim,
    )


def forward(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: EncoderConfig, fused: str = "on", qlayers: list | None = None,
    fused_layers: bool = False,
) -> torch.Tensor:
    """Hidden states (B, S, H) after the final norm.

    fused: "on" = the fused attention block where the shapes qualify (the
    CUDA kernel for CUDA tensors); "plain" = the same block through the
    kernel's plain version, with the kernel's casts (the counterpart of
    the reference's fused="interpret"); "off" = the reference's plain
    composition throughout.

    qlayers: per-layer int8 weights (`quantize_params_int8`, or the
    reference's carried over by `params_from_jax`): every projection runs
    as an exact int8 product (w8a8).

    fused_layers: with qlayers set and fused not "off", each transformer
    sub-block whose shapes qualify (`_fused_layer_ok`) is one whole-layer
    call (kernels B3 and B4 on the card, their plain versions for
    fused="plain" or CPU tensors)."""
    if fused not in ("on", "plain", "off"):
        raise ValueError(f"fused must be 'on', 'plain' or 'off', got {fused!r}")
    if is_sharded(params):
        if qlayers is not None:
            raise ValueError(_INT8_TP)
        return _forward_tp(params, input_ids, attention_mask, cfg, fused)
    x = params["embed"][input_ids.long()].to(_DTYPES[cfg.dtype])
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)
    mask = attention_mask.bool()
    rope_cs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    b, s = input_ids.shape
    use_fused = fused != "off" and _fused_ok(cfg, s, b)
    plain = fused == "plain"
    if fused_layers and qlayers is not None and fused != "off" and _fused_layer_ok(cfg, s, b):
        attn_layer = fused_attn_int8_layer_plain if plain else fused_attn_int8_layer
        mlp_layer = fused_mlp_int8_layer_plain if plain else fused_mlp_int8_layer
        for layer, lq in zip(params["layers"], qlayers):
            x = attn_layer(x, layer, lq, attention_mask, rope_cs, cfg)
            x = mlp_layer(x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"],
                          eps=cfg.rms_norm_eps)
        return _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    for li, layer in enumerate(params["layers"]):
        if qlayers is not None:
            x = x + _attention_int8(layer, qlayers[li], x, attention_mask, rope_cs, cfg,
                                    use_fused, plain)
            x = x + _mlp_int8(layer, qlayers[li], x, cfg.rms_norm_eps)
            continue
        xa = _rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        if use_fused:
            x = x + _attention_fused(layer, xa, attention_mask, rope_cs, cfg, plain)
        else:
            x = x + _attention(layer, xa, mask, rope_cs, cfg)
        x = x + _mlp(layer, _rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))
    return _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def _forward_tp(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: EncoderConfig, fused: str) -> torch.Tensor:
    """`forward` over sharded params (`shard_params`, or a data row's view
    of them, `sharding.row_params`), on the devices of their shards; the
    hidden states come back on the first. The same attention dispatch as
    the unsharded path (`_fused_ok` on the whole batch), with the core on
    each shard's heads where the kv heads divide over the shards."""
    tp = TP(params["embed"])
    ids, am = input_ids.to(tp.first), attention_mask.to(tp.first)
    x = tp.embed(params["embed"], ids).to(_DTYPES[cfg.dtype])
    positions = torch.clamp(torch.cumsum(am.to(torch.int32), dim=1) - 1, min=0)
    rope_cs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    b, s = ids.shape
    use_fused = fused != "off" and _fused_ok(cfg, s, b)
    plain = fused == "plain"
    eps = cfg.rms_norm_eps
    on = {d: (rope_cs[0].to(d), rope_cs[1].to(d), am.to(d), am.bool().to(d)) for d in set(tp.devices)}
    for layer in params["layers"]:
        qn, kn = tp.rep(layer["q_norm"]), tp.rep(layer["k_norm"])

        def core(q, k, v, dev, div):
            lcfg = cfg.replace(num_heads=cfg.num_heads // div, num_kv_heads=cfg.num_kv_heads // div)
            norms = {"q_norm": qn.to(dev), "k_norm": kn.to(dev)}
            cos, sin, am_d, mask_d = on[dev]
            if use_fused:
                return _attention_core(norms, q, k, v, am_d, (cos, sin), lcfg, plain).to(q.dtype)
            return _attention_math(norms, q, k, v, mask_d, (cos, sin), lcfg)

        xs = tp.bcast(_rms_norm(x, layer["attn_norm"], eps))
        attn = tp.attention(tp.col(xs, layer["wq"]), tp.col(xs, layer["wk"]), tp.col(xs, layer["wv"]),
                            cfg.num_kv_heads, core)
        x = x + tp.row(attn, layer["wo"])
        xs = tp.bcast(_rms_norm(x, layer["mlp_norm"], eps))
        h = [F.silu(g.float()).to(x.dtype) * u
             for g, u in zip(tp.col(xs, layer["w_gate"]), tp.col(xs, layer["w_up"]))]
        x = x + tp.row(h, layer["w_down"])
    return _rms_norm(x, params["final_norm"], eps)


def encode_pooled(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: EncoderConfig, fused: str = "on", qlayers: list | None = None,
    fused_layers: bool = False,
) -> torch.Tensor:
    """Pooled, L2-normalized embeddings (B, D) f32: the last non-padding
    (EOS) position for qwen, or the masked mean."""
    hidden = forward(params, input_ids, attention_mask, cfg, fused=fused, qlayers=qlayers,
                     fused_layers=fused_layers)
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


# ---------------------------------------------------------------------------
# sharding rules (dp over 'data', tp over 'shard')
# ---------------------------------------------------------------------------

_INT8_TP = ("int8 (w8a8) runs on one device or a dp-only mesh: the tp sharding rules have "
            "no int8 form")


def param_sharding_rules(mesh, tp_axis: str = "shard") -> Params:
    """The reference's spec tree (model.py:param_sharding_rules): q/k/v and
    gate/up column-sharded over the head / intermediate dimension, wo and
    w_down row-sharded (one reduction a matmul pair), the embedding
    vocab-sharded, the norms replicated."""
    t = tp_axis
    layer_rules = {
        "attn_norm": (None,),
        "wq": (None, t),
        "wk": (None, t),
        "wv": (None, t),
        "wo": (t, None),
        "q_norm": (None,),
        "k_norm": (None,),
        "mlp_norm": (None,),
        "w_gate": (None, t),
        "w_up": (None, t),
        "w_down": (t, None),
    }
    return {"embed": (t, None), "final_norm": (None,), "layers": layer_rules}


def shard_params(params: Params, mesh, tp_axis: str = "shard") -> Params:
    """Params placed on the mesh by the tp rules (fresh copies)."""
    return place_params(params, param_sharding_rules(mesh, tp_axis), mesh)
