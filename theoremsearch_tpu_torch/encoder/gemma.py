"""EmbeddingGemma-300m-class text encoder on tensors (port of
theoremsearch_tpu/encoder/gemma.py).

A Gemma3 text tower run bidirectionally, with the sentence-transformers
head: token embedding scaled by sqrt(hidden) (the scale rounded to the
model dtype: 27.75 in bf16 for d 768) -> N x ((1 + w) RMSNorm ->
bidirectional grouped-query attention with per-head (1 + w) q/k RMSNorm,
RoPE (global layers rope_theta with linear scaling, sliding layers
rope_local_theta) and the logit scale query_pre_attn_scalar^-1/2 ->
post-attention norm -> residual; pre-MLP norm -> GeGLU (tanh GELU) ->
post-MLP norm -> residual) -> final norm -> mean pool -> Dense -> Dense
-> L2 normalize.

Sliding layers attend to keys at |q_pos - kv_pos| < sliding_window // 2 + 1
on real token positions; global layers to every valid key. Params are a
plain dict of tensors with the reference's names, so `params_from_jax`
carries JAX weights over.

The attention core goes through kernel B2's gemma form (head_dim 256,
bidirectional; `kernels/attention.py`) where the reference takes its
fused Pallas kernel (`_fused_ok`: head_dim a multiple of 128, S <= 128,
and S - 1 <= sliding_window // 2, so the window cannot bind and every
layer is fully bidirectional). Its gradient is autograd through the
reference's composition, recomputed from the saved inputs
(`GemmaAttentionCore`), as the reference's custom VJP takes jax.vjp of
it: there is no gemma form of the fused backward kernel B7.

int8 (w8a8) serving mode shares the qwen tower's quantizer; with
`fused_layers=True` each sandwich sub-block whose shapes qualify is one
whole-layer call in its gemma form (kernels B3 and B4 on the card).

Tensor parallelism as the qwen tower's (`encoder/model.py`): the
reference's rules with the ST head's head_w1 column- and head_w2
row-sharded; with the full model's 3/1 heads the core runs gathered on
the first device (one kv head does not divide over the shards).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import GemmaEncoderConfig
from ..kernels.attention import fused_qknorm_rope_attention, fused_qknorm_rope_attention_plain
from ..kernels.layer_int8 import (
    fused_attn_int8_layer_gemma,
    fused_attn_int8_layer_gemma_plain,
    fused_layer_shapes_ok,
    fused_mlp_int8_layer,
    fused_mlp_int8_layer_plain,
    gelu_tanh,
)
from ..utils.device import resolve_device, tf32_off
from .model import (  # the shared int8 machinery and the JAX carry-over
    _DTYPES,
    _INT8_TP,
    _q_matmul,
    _quant_act,
    _rmsnorm_quant_act,
    _rope,
    params_from_jax,
    quantize_params_int8,
)
from .sharding import TP, is_sharded, place_params

Params = dict[str, Any]

__all__ = ["init_params", "params_from_jax", "quantize_params_int8", "forward", "encode_pooled",
           "is_global_layer", "GemmaAttentionCore", "param_sharding_rules", "shard_params"]


def is_global_layer(cfg: GemmaEncoderConfig, li: int) -> bool:
    return (li + 1) % cfg.global_every == 0


def init_params(cfg: GemmaEncoderConfig, generator: torch.Generator, device=None) -> Params:
    """Random init from an explicit generator, which must live on `device`
    (default: the card; pass "cpu" for a CPU run): zero (1 + w) norm
    weights as Gemma3 initializes them, N(0, 0.02^2) matrices (its
    initializer_range) and zero head biases. (The reference draws dense
    weights N(0, 1/in); tests carry JAX weights over rather than match its
    draws.)"""
    device = resolve_device(device)
    pdtype = _DTYPES[cfg.param_dtype]
    q_dim = cfg.head_dim * cfg.num_heads
    kv_dim = cfg.head_dim * cfg.num_kv_heads

    def dense(i, o):
        w = torch.randn((i, o), generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(pdtype)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    d = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": zeros(d), "post_attn_norm": zeros(d),
            "wq": dense(d, q_dim), "wk": dense(d, kv_dim), "wv": dense(d, kv_dim),
            "wo": dense(q_dim, d),
            "q_norm": zeros(cfg.head_dim), "k_norm": zeros(cfg.head_dim),
            "pre_mlp_norm": zeros(d), "post_mlp_norm": zeros(d),
            "w_gate": dense(d, cfg.intermediate_size), "w_up": dense(d, cfg.intermediate_size),
            "w_down": dense(cfg.intermediate_size, d),
        })
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=device,
                        dtype=torch.float32) * 0.02
    return {
        "embed": embed.to(pdtype), "final_norm": zeros(d), "layers": layers,
        # the sentence-transformers head (2_Dense, 3_Dense): identity
        # activation, with bias
        "head_w1": dense(d, cfg.head_hidden), "head_b1": zeros(cfg.head_hidden),
        "head_w2": dense(cfg.head_hidden, cfg.embedding_dim), "head_b2": zeros(cfg.embedding_dim),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma's form: f32 norm, times (1 + w), cast after the multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)


def _rope_tables(positions: torch.Tensor, dh: int, theta: float, scaling_factor: float = 1.0):
    """cos/sin (B, S, half) f32; linear rope scaling divides the inverse
    frequencies (HF's rope_scaling "linear")."""
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / torch.pow(base, exps)
    if scaling_factor != 1.0:
        freqs = freqs / scaling_factor
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _attention_math(layer, q, k, v, valid, rope_cs, cfg: GemmaEncoderConfig) -> torch.Tensor:
    """The reference's composition after the projections: (1 + w) q/k
    norms, RoPE, GQA repeat, the scaled masked softmax and PV. `valid` is
    the (B, 1, S, S) pair mask (padding and, on sliding layers, the
    window). (B, S, H*Dh) pre-wo."""
    b, s, _ = q.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_cs
    dtype = q.dtype
    q = _rope(_gemma_rms_norm(q.reshape(b, s, h, dh), layer["q_norm"], cfg.rms_norm_eps), cos, sin)
    k = _rope(_gemma_rms_norm(k.reshape(b, s, hk, dh), layer["k_norm"], cfg.rms_norm_eps), cos, sin)
    rep = h // hk
    k = k.repeat_interleave(rep, dim=2)
    v = v.reshape(b, s, hk, dh).repeat_interleave(rep, dim=2)
    scale = float(cfg.query_pre_attn_scalar) ** -0.5
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = torch.where(valid, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype).reshape(b, s, h * dh)


def _attention(layer, x, valid, rope_cs, cfg) -> torch.Tensor:
    out = _attention_math(layer, x @ layer["wq"], x @ layer["wk"], x @ layer["wv"], valid,
                          rope_cs, cfg)
    return out @ layer["wo"]


def _core_composition(q, k, v, qw1, kw1, cos, sin, mask, h, hk, dh, eps, scale):
    """The reference's `ref` (gemma.py:_make_attn_core): the fused core's
    function written as ops, with the (1 + w) weights pre-adjusted and the
    logit scale applied after the dot. Its autograd is the fused core's
    gradient."""
    b, s, _ = q.shape

    def norm(x, w1):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * w1).to(x.dtype)

    q4 = _rope(norm(q.reshape(b, s, h, dh), qw1), cos, sin)
    k4 = _rope(norm(k.reshape(b, s, hk, dh), kw1), cos, sin)
    rep = h // hk
    k4 = k4.repeat_interleave(rep, dim=2)
    v4 = v.reshape(b, s, hk, dh).repeat_interleave(rep, dim=2)
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", q4.float(), k4.float()) * scale
        logits = torch.where((mask != 0)[:, None, None, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v4.float())
    return out.to(torch.bfloat16).reshape(b, s, h * dh)


class GemmaAttentionCore(torch.autograd.Function):
    """The gemma form of the fused attention core with its gradient:
    forward kernel B2 (head_dim 256, bidirectional; its plain version for
    CPU tensors or plain=True), backward autograd through
    `_core_composition` recomputed from the saved inputs. The counterpart
    of the reference's custom VJP (gemma.py:_make_attn_core). A ctypes
    output carries no grad_fn, so without this Function no gradient would
    reach wq, wk, wv or the q/k norms through the kernel.

        GemmaAttentionCore.apply(q, k, v, qw1, kw1, cos, sin, mask,
                                 num_heads, num_kv_heads, head_dim, eps, scale, plain)
    """

    @staticmethod
    def forward(ctx, q, k, v, qw1, kw1, cos, sin, mask, num_heads, num_kv_heads, head_dim,
                eps, scale, plain):
        ctx.save_for_backward(q, k, v, qw1, kw1, cos, sin, mask)
        ctx.shape = (num_heads, num_kv_heads, head_dim, eps, scale)
        fn = fused_qknorm_rope_attention_plain if plain else fused_qknorm_rope_attention
        return fn(q, k, v, qw1, kw1, cos, sin, mask, num_heads=num_heads,
                  num_kv_heads=num_kv_heads, head_dim=head_dim, eps=eps, causal=False,
                  scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qw1, kw1, cos, sin, mask = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True) for t in (q, k, v, qw1, kw1)]
        with torch.enable_grad():
            out = _core_composition(*ins, cos, sin, mask, *ctx.shape)
        grads = torch.autograd.grad(out, ins, g.to(out.dtype))
        return (*grads, None, None, None, None, None, None, None, None, None)


def _fused_ok(cfg: GemmaEncoderConfig, s: int, b: int) -> bool:
    """The reference's gate for its fused gemma path: a 128-multiple
    head_dim, S <= 128, a batch divisible by its packing factor, and S
    small enough that the bidirectional window cannot bind (S - 1 <=
    sliding_window // 2), so every layer is fully bidirectional."""
    bb = max(1, 128 // s)
    return (
        cfg.head_dim % 128 == 0
        and s <= 128
        and (s - 1) <= cfg.sliding_window // 2
        and b % bb == 0
        and cfg.num_heads % cfg.num_kv_heads == 0
    )


def _fused_layer_ok(cfg: GemmaEncoderConfig, s: int, b: int) -> bool:
    """The whole-layer int8 kernels additionally need 128-aligned dims
    within the reference's weight budget (`fused_layer_shapes_ok`)."""
    return _fused_ok(cfg, s, b) and fused_layer_shapes_ok(
        cfg.hidden_size, cfg.intermediate_size,
        cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim,
    )


def _attention_core(layer, q, k, v, attention_mask, rope_cs, cfg, plain: bool) -> torch.Tensor:
    return GemmaAttentionCore.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), 1.0 + layer["q_norm"].float(),
        1.0 + layer["k_norm"].float(), rope_cs[0], rope_cs[1], attention_mask.to(torch.int32),
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_norm_eps,
        float(cfg.query_pre_attn_scalar) ** -0.5, plain)


def _attention_fused(layer, x, attention_mask, rope_cs, cfg, plain: bool) -> torch.Tensor:
    attn = _attention_core(layer, x @ layer["wq"], x @ layer["wk"], x @ layer["wv"],
                           attention_mask, rope_cs, cfg, plain)
    return attn.to(x.dtype) @ layer["wo"]


def _mlp(layer, x: torch.Tensor) -> torch.Tensor:
    """GeGLU with the tanh GELU, the gate in f32."""
    gate = gelu_tanh((x @ layer["w_gate"]).float()).to(x.dtype)
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


# ---------------------------------------------------------------------------
# int8 (w8a8): the qwen tower's scheme on the same seven matrices; only the
# block composition (sandwich norms, GeGLU, bidirectional core) differs
# ---------------------------------------------------------------------------


def _attention_int8(layer, lq, x, attention_mask, valid, rope_cs, cfg, use_fused: bool,
                    plain: bool) -> torch.Tensor:
    """`x` is PRE-norm: the (1 + w) attention norm fuses into the shared
    activation quant (w_offset=1.0)."""
    xq, sx = _rmsnorm_quant_act(x, layer["attn_norm"], cfg.rms_norm_eps, w_offset=1.0)
    q, k, v = (_q_matmul(xq, sx, lq[n], x.dtype) for n in ("wq", "wk", "wv"))
    if use_fused:
        attn = _attention_core(layer, q, k, v, attention_mask, rope_cs, cfg, plain)
    else:
        attn = _attention_math(layer, q, k, v, valid, rope_cs, cfg)
    aq, sa = _quant_act(attn.to(x.dtype))
    return _q_matmul(aq, sa, lq["wo"], x.dtype)


def _mlp_int8(layer, lq, x: torch.Tensor, eps: float) -> torch.Tensor:
    """GeGLU with int8 products; `x` is PRE-norm."""
    xq, sx = _rmsnorm_quant_act(x, layer["pre_mlp_norm"], eps, w_offset=1.0)
    gate = _q_matmul(xq, sx, lq["w_gate"], torch.float32)
    up = _q_matmul(xq, sx, lq["w_up"], torch.float32)
    h = (gelu_tanh(gate) * up).to(x.dtype)
    hq, sh = _quant_act(h)
    return _q_matmul(hq, sh, lq["w_down"], x.dtype)


def forward(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: GemmaEncoderConfig, fused: str = "on", qlayers: list | None = None,
    fused_layers: bool = False,
) -> torch.Tensor:
    """Hidden states (B, S, H) after the final norm.

    fused: "on" = the fused attention core where `_fused_ok` qualifies
    the shapes (kernel B2's gemma form for CUDA tensors); "plain" = the
    same through the kernel's plain version (the counterpart of the
    reference's fused="interpret"); "off" = the reference composition
    throughout.

    qlayers: per-layer int8 weights (`quantize_params_int8`): every
    projection an exact int8 product (w8a8).

    fused_layers: with qlayers set and fused not "off", each sandwich
    sub-block is one whole-layer call in its gemma form where
    `_fused_layer_ok` qualifies the shapes (kernels B3 and B4 on the card,
    their plain versions for fused="plain" or CPU tensors)."""
    if fused not in ("on", "plain", "off"):
        raise ValueError(f"fused must be 'on', 'plain' or 'off', got {fused!r}")
    if is_sharded(params):
        if qlayers is not None:
            raise ValueError(_INT8_TP)
        return _forward_tp(params, input_ids, attention_mask, cfg, fused)
    dtype = _DTYPES[cfg.dtype]
    eps = cfg.rms_norm_eps
    # the sqrt(hidden) scale lives in the model dtype (HF rounds it so)
    embed_scale = float(torch.tensor(np.sqrt(cfg.hidden_size), dtype=dtype))
    x = (params["embed"][input_ids.long()].float() * embed_scale).to(dtype)
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)
    mask = attention_mask.bool()
    rope_global = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_factor)
    rope_local = _rope_tables(positions, cfg.head_dim, cfg.rope_local_theta)
    b, s = input_ids.shape
    use_fused = fused != "off" and _fused_ok(cfg, s, b)
    plain = fused == "plain"
    if fused_layers and qlayers is not None and fused != "off" and _fused_layer_ok(cfg, s, b):
        attn_layer = fused_attn_int8_layer_gemma_plain if plain else fused_attn_int8_layer_gemma
        mlp_layer = fused_mlp_int8_layer_plain if plain else fused_mlp_int8_layer
        for li, (layer, lq) in enumerate(zip(params["layers"], qlayers)):
            rope_cs = rope_global if is_global_layer(cfg, li) else rope_local
            x = attn_layer(x, layer, lq, attention_mask, rope_cs, cfg)
            x = mlp_layer(x, 1.0 + layer["pre_mlp_norm"].float(), lq["w_gate"], lq["w_up"],
                          lq["w_down"], 1.0 + layer["post_mlp_norm"].float(), eps=eps,
                          act="gelu_tanh")
        return _gemma_rms_norm(x, params["final_norm"], eps)
    valid_full = mask[:, None, None, :].expand(b, 1, s, s)
    # the raw window split across both directions on real positions:
    # |d| < W // 2 + 1 (HF's bidirectional rewrite of sliding_window);
    # where use_fused holds it cannot bind
    dist = (positions[:, :, None] - positions[:, None, :]).abs()
    valid_sliding = valid_full & (dist < cfg.sliding_window // 2 + 1)[:, None]
    for li, layer in enumerate(params["layers"]):
        glob = is_global_layer(cfg, li)
        rope_cs = rope_global if glob else rope_local
        valid = valid_full if glob else valid_sliding
        if qlayers is not None:
            attn = _attention_int8(layer, qlayers[li], x, attention_mask, valid, rope_cs, cfg,
                                   use_fused, plain)
        else:
            xa = _gemma_rms_norm(x, layer["attn_norm"], eps)
            if use_fused:
                attn = _attention_fused(layer, xa, attention_mask, rope_cs, cfg, plain)
            else:
                attn = _attention(layer, xa, valid, rope_cs, cfg)
        x = x + _gemma_rms_norm(attn, layer["post_attn_norm"], eps)
        if qlayers is not None:
            mlp = _mlp_int8(layer, qlayers[li], x, eps)
        else:
            mlp = _mlp(layer, _gemma_rms_norm(x, layer["pre_mlp_norm"], eps))
        x = x + _gemma_rms_norm(mlp, layer["post_mlp_norm"], eps)
    return _gemma_rms_norm(x, params["final_norm"], eps)


def _forward_tp(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: GemmaEncoderConfig, fused: str) -> torch.Tensor:
    """`forward` over sharded params, as the qwen tower's `_forward_tp`:
    the sandwich norms, residuals and masks on the first device, the
    projections and GeGLU on each shard's blocks, the core head-local or
    gathered (`sharding.TP.attention`)."""
    tp = TP(params["embed"])
    ids, am = input_ids.to(tp.first), attention_mask.to(tp.first)
    dtype = _DTYPES[cfg.dtype]
    eps = cfg.rms_norm_eps
    embed_scale = float(torch.tensor(np.sqrt(cfg.hidden_size), dtype=dtype))
    x = (tp.embed(params["embed"], ids).float() * embed_scale).to(dtype)
    positions = torch.clamp(torch.cumsum(am.to(torch.int32), dim=1) - 1, min=0)
    mask = am.bool()
    rope_global = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_factor)
    rope_local = _rope_tables(positions, cfg.head_dim, cfg.rope_local_theta)
    b, s = ids.shape
    use_fused = fused != "off" and _fused_ok(cfg, s, b)
    plain = fused == "plain"
    valid_full = mask[:, None, None, :].expand(b, 1, s, s)
    dist = (positions[:, :, None] - positions[:, None, :]).abs()
    valid_sliding = valid_full & (dist < cfg.sliding_window // 2 + 1)[:, None]
    # each device's copies: the mask, and (rope tables, pair mask) by layer kind
    on = {d: (am.to(d), {True: ([t.to(d) for t in rope_global], valid_full.to(d)),
                         False: ([t.to(d) for t in rope_local], valid_sliding.to(d))})
          for d in set(tp.devices)}
    for li, layer in enumerate(params["layers"]):
        glob = is_global_layer(cfg, li)
        qn, kn = tp.rep(layer["q_norm"]), tp.rep(layer["k_norm"])

        def core(q, k, v, dev, div):
            lcfg = cfg.replace(num_heads=cfg.num_heads // div, num_kv_heads=cfg.num_kv_heads // div)
            norms = {"q_norm": qn.to(dev), "k_norm": kn.to(dev)}
            am_d, kinds = on[dev]
            rope_cs, valid = kinds[glob]
            if use_fused:
                return _attention_core(norms, q, k, v, am_d, rope_cs, lcfg, plain).to(q.dtype)
            return _attention_math(norms, q, k, v, valid, rope_cs, lcfg)

        xs = tp.bcast(_gemma_rms_norm(x, layer["attn_norm"], eps))
        attn = tp.attention(tp.col(xs, layer["wq"]), tp.col(xs, layer["wk"]), tp.col(xs, layer["wv"]),
                            cfg.num_kv_heads, core)
        x = x + _gemma_rms_norm(tp.row(attn, layer["wo"]), layer["post_attn_norm"], eps)
        xs = tp.bcast(_gemma_rms_norm(x, layer["pre_mlp_norm"], eps))
        h = [gelu_tanh(g.float()).to(x.dtype) * u
             for g, u in zip(tp.col(xs, layer["w_gate"]), tp.col(xs, layer["w_up"]))]
        x = x + _gemma_rms_norm(tp.row(h, layer["w_down"]), layer["post_mlp_norm"], eps)
    return _gemma_rms_norm(x, params["final_norm"], eps)


def _head_tp(params: Params, pooled: torch.Tensor) -> torch.Tensor:
    """The ST head over sharded params: head_w1's column blocks (with the
    matching blocks of the replicated head_b1, `TP.split`), head_w2's row
    blocks, the partials summed on the first device (and over the row's
    processes); f32 with TF32 off."""
    tp = TP(params["head_w1"])
    hs = [x @ w.float() for x, w in zip(tp.bcast(pooled), params["head_w1"].pieces)]
    hs = [h + b1 for h, b1 in zip(hs, tp.split(params["head_b1"].float().to(tp.first)))]
    return tp.reduce([h @ w.float() for h, w in zip(hs, params["head_w2"].pieces)]) + \
        params["head_b2"].float().to(tp.first)


def encode_pooled(
    params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
    cfg: GemmaEncoderConfig, fused: str = "on", qlayers: list | None = None,
    fused_layers: bool = False,
) -> torch.Tensor:
    """Pooled embeddings (B, embedding_dim) f32: mean over valid tokens ->
    Dense -> Dense (with biases, f32, TF32 off) -> L2 normalize (the
    sentence-transformers stack of embeddinggemma). A bare Gemma3 tower
    without the head pools the hidden state itself."""
    hidden = forward(params, input_ids, attention_mask, cfg, fused=fused, qlayers=qlayers,
                     fused_layers=fused_layers)
    m = attention_mask[:, :, None].float()
    pooled = (hidden.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    if "head_w1" in params and is_sharded(params):
        with tf32_off():
            pooled = _head_tp(params, pooled)
    elif "head_w1" in params:
        with tf32_off():
            pooled = pooled @ params["head_w1"].float() + params["head_b1"].float()
            pooled = pooled @ params["head_w2"].float() + params["head_b2"].float()
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


# ---------------------------------------------------------------------------
# sharding rules (dp over 'data', tp over 'shard'): the qwen tower's layout
# with the sandwich norms, and the ST head column- then row-sharded
# ---------------------------------------------------------------------------


def param_sharding_rules(mesh, tp_axis: str = "shard") -> Params:
    """The reference's spec tree (gemma.py:param_sharding_rules)."""
    t = tp_axis
    layer_rules = {
        "attn_norm": (None,),
        "post_attn_norm": (None,),
        "wq": (None, t),
        "wk": (None, t),
        "wv": (None, t),
        "wo": (t, None),
        "q_norm": (None,),
        "k_norm": (None,),
        "pre_mlp_norm": (None,),
        "post_mlp_norm": (None,),
        "w_gate": (None, t),
        "w_up": (None, t),
        "w_down": (t, None),
    }
    return {
        "embed": (t, None),
        "final_norm": (None,),
        "layers": layer_rules,
        "head_w1": (None, t),
        "head_b1": (None,),
        "head_w2": (t, None),
        "head_b2": (None,),
    }


def shard_params(params: Params, mesh, tp_axis: str = "shard") -> Params:
    """Params placed on the mesh by the tp rules (fresh copies)."""
    return place_params(params, param_sharding_rules(mesh, tp_axis), mesh)
