"""A DeepSeek-V3-block text encoder (Moonlight-16B-A3B's architecture,
HF `modeling_deepseek.py`), used as an embedder: bf16 serving forward,
last-token pooling, L2 normalize. Port-only: the JAX package has no such
tower, so its config and its dispatch live here and in `towers.py`.

token embedding -> N x (RMSNorm -> latent attention -> RMSNorm -> FFN)
-> final RMSNorm -> the last real token -> L2 normalize. The FFN of the
first `first_k_dense_replace` layers is a dense SwiGLU; every later one
is a mixture of experts.

Latent attention (MLA, `q_lora_rank` null): q = x W_q gives each head a
`qk_nope_head_dim` part and a `qk_rope_head_dim` part; x W_kv_a gives a
`kv_lora_rank` latent c_kv and one rope key shared by the heads; c_kv is
RMSNormed and W_kv_b gives each head its k_nope and v. RoPE rotates the
adjacent pairs (2j, 2j + 1) of the rope parts by angle pos theta^(-2j/d)
(HF permutes them with `view(..., d/2, 2).transpose` before
`rotate_half`) and leaves them in HF's order: the pairs' first elements,
then their second. Scores are [q_nope | q_pe] . [k_nope | k_pe] x
(nope + rope)^-1/2, causal, times v, then W_o. The core is
`F.scaled_dot_product_attention(is_causal=True)`: under the encoder's
right padding each real row sees only real keys, so causal masking is
exact for every real row.

The experts (`kernels/moe.py`): only the real tokens are routed. Their
rows of the flattened (B S) batch come from the host (`tokens`, which
`BatchedEncoder` uploads with the ids), so the forward reads nothing back
from the card. The router runs in f32 (logits x W_gate^T, sigmoid); the
top k by score + `e_score_correction_bias`; each pick weighted by its
unbiased score over the k's sum, times `routed_scaling_factor`. The pairs
are sorted by expert on the card, the two grouped products run once each,
the shared experts (one SwiGLU of n_shared x moe_intermediate) on the real
rows, and the combine adds it all into the residual at the real rows; the
padding rows get no FFN (they reach no real row: causal, right-padded).

Params (dense matrices (in, out), as the other towers; expert matrices
(E, out, in), the checkpoint's own layout, K-contiguous for the grouped
kernel): embed, final_norm, layers[i] = {attn_norm, wq, wkv_a, kv_norm,
wkv_b, wo, mlp_norm} plus {w_gate, w_up, w_down} (dense) or {router (E, H)
f32, router_bias (E,) f32, experts_gate, experts_up (E, I, H),
experts_down (E, H, I), shared: {w_gate, w_up, w_down}} (experts).

Spans: `ts.encoder.route` (router, top-k, sort, offsets) and
`ts.encoder.experts` (the grouped products, the shared experts, the
combine). Counters: `MoECounters` (`BatchedEncoder.stats()["moe"]`).
Inference only: a gradient, an int8 mode or a tensor-parallel placement
raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import _JsonConfig
from ..kernels import moe
from ..utils.device import resolve_device, tf32_off
from ..utils.profiling import span
from .model import _DTYPES, _mlp, _rms_norm

Params = dict[str, Any]


@dataclass(frozen=True)
class DeepseekEncoderConfig(_JsonConfig):
    """Moonlight-16B-A3B's published `config.json` (model_type
    deepseek_v3), plus the embedder's pooling."""

    vocab_size: int = 163_840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    intermediate_size: int = 11_264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    rope_theta: float = 50_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 512
    embedding_dim: int = 2048
    pooling: str = "last_token"
    normalize: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise ValueError("the deepseek tower takes q_lora_rank null (a full-rank W_q)")
        if self.scoring_func != "sigmoid" or self.topk_method != "noaux_tc":
            raise ValueError("the deepseek tower routes by sigmoid scores with the noaux_tc top-k")
        if self.pooling != "last_token" or self.embedding_dim != self.hidden_size:
            raise ValueError("the deepseek tower pools the last real token at the hidden size")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even (RoPE rotates pairs)")

    @classmethod
    def tiny(cls) -> "DeepseekEncoderConfig":
        """A small config for tests and dry runs: a dense layer and two
        expert layers, 8 experts, top 2, one shared expert."""
        return cls(vocab_size=1024, hidden_size=64, num_layers=3, num_heads=4, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
                   num_experts_per_tok=2, n_shared_experts=1, max_seq_len=64, embedding_dim=64)

    @property
    def n_moe_layers(self) -> int:
        return max(0, self.num_layers - self.first_k_dense_replace)


class MoECounters:
    """The expert layers' counts for one width bucket: `launches` of the
    grouped kernels (on the host) and, on the tokens' device, `acc` =
    (pairs routed, real tokens, experts with a pair, the busiest expert's
    pairs), each summed over layer calls. `read()` is the one place they
    come to the host."""

    def __init__(self, device):
        self.launches = 0
        self.acc = torch.zeros(4, dtype=torch.int64, device=device)

    def read(self) -> dict:
        pairs, real, touched, max_rows = self.acc.tolist()
        return {"launches": self.launches, "pairs": pairs, "real_tokens": real,
                "experts_touched": touched, "max_rows": max_rows}


def init_params(cfg: DeepseekEncoderConfig, generator: torch.Generator, device=None) -> Params:
    """Random init from an explicit generator on `device` (default: the
    card): matrices N(0, 0.02^2) (the published initializer_range), norm
    gains 1, the router's weight N(0, 0.02^2) in f32 and its bias 0."""
    device = resolve_device(device)
    pdtype = _DTYPES[cfg.param_dtype]
    h, nh = cfg.hidden_size, cfg.num_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank

    def dense(*shape, dtype=pdtype):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    layers = []
    for li in range(cfg.num_layers):
        layer = {"attn_norm": ones(h), "wq": dense(h, nh * (dn + dr)), "wkv_a": dense(h, r + dr),
                 "kv_norm": ones(r), "wkv_b": dense(r, nh * (dn + dv)), "wo": dense(nh * dv, h),
                 "mlp_norm": ones(h)}
        if li < cfg.first_k_dense_replace:
            i = cfg.intermediate_size
            layer.update(w_gate=dense(h, i), w_up=dense(h, i), w_down=dense(i, h))
        else:
            e, i, si = cfg.n_routed_experts, cfg.moe_intermediate_size, (
                cfg.n_shared_experts * cfg.moe_intermediate_size)
            layer.update(router=dense(e, h, dtype=torch.float32),
                         router_bias=torch.zeros((e,), dtype=torch.float32, device=device),
                         experts_gate=dense(e, i, h), experts_up=dense(e, i, h),
                         experts_down=dense(e, h, i),
                         shared={"w_gate": dense(h, si), "w_up": dense(h, si),
                                 "w_down": dense(si, h)})
        layers.append(layer)
    return {"embed": dense(cfg.vocab_size, h), "final_norm": ones(h), "layers": layers}


def rope_tables(s: int, dim: int, theta: float, device):
    """cos, sin (S, dim / 2) f32 at positions 0 .. S - 1: pair j's angle is
    pos theta^(-2j / dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_adjacent(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, heads, dim) with the adjacent pairs (2j, 2j + 1) rotated by
    pair j's angle, in f32, cast back; out in HF's order: [first elements
    of the pairs | second elements]."""
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1).to(x.dtype)


def _attention(layer, a, cos, sin, cfg) -> torch.Tensor:
    """The latent attention block on normed a (B, S, H): out (B, S, H)."""
    b, s, _ = a.shape
    nh, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (a @ layer["wq"]).view(b, s, nh, dn + dr)
    kva = a @ layer["wkv_a"]
    c_kv, k_pe = kva[..., : cfg.kv_lora_rank], kva[..., cfg.kv_lora_rank :]
    kv = (_rms_norm(c_kv, layer["kv_norm"], cfg.rms_norm_eps) @ layer["wkv_b"]).view(b, s, nh, dn + dv)
    q_pe = rope_adjacent(q[..., dn:], cos, sin)
    k_pe = rope_adjacent(k_pe.reshape(b, s, 1, dr), cos, sin).expand(b, s, nh, dr)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(1, 2)
    kh = torch.cat([kv[..., :dn], k_pe], dim=-1).transpose(1, 2)
    vh = kv[..., dn:].transpose(1, 2)
    o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=(dn + dr) ** -0.5)
    return o.transpose(1, 2).reshape(b, s, nh * dv) @ layer["wo"]


def route(layer, xr: torch.Tensor, cfg: DeepseekEncoderConfig):
    """(picks (T, k) int64, weights (T, k) f32) of the real rows xr (T, H):
    f32 logits, sigmoid scores, the top k of score + bias (in order of it),
    the unbiased scores over their sum times the scaling factor."""
    with tf32_off():
        scores = torch.sigmoid(xr.float() @ layer["router"].float().T)
    _, top = torch.topk(scores + layer["router_bias"], cfg.num_experts_per_tok, dim=-1)
    w = scores.gather(1, top)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return top, w * cfg.routed_scaling_factor


def _moe_into(layer, m: torch.Tensor, x: torch.Tensor, tokens: torch.Tensor,
              cfg: DeepseekEncoderConfig, counters: MoECounters | None, record) -> None:
    """x[tokens] += the expert layer's output on the normed rows m[tokens]
    (m, x: (B S, H)), in place."""
    with span("ts.encoder.route"):
        xr = m.index_select(0, tokens)
        top, w = route(layer, xr, cfg)
        if record is not None:
            record.copy_(top)
        rows, offsets, inv = moe.route_plan(top, cfg.n_routed_experts,
                                            counters.acc if counters is not None else None)
    with span("ts.encoder.experts"):
        n0 = moe.grouped_launches.n
        h = moe.grouped_swiglu(xr, rows, offsets, layer["experts_gate"], layer["experts_up"])
        y = moe.grouped_down(h, offsets, layer["experts_down"])
        shared = _mlp(layer["shared"], xr)
        moe.combine_into(x, tokens, y, inv, w.contiguous(), shared)
        if counters is not None:
            counters.launches += moe.grouped_launches.n - n0


def real_token_rows(mask: np.ndarray) -> np.ndarray:
    """The rows of the flattened (B S) batch that hold real tokens, from a
    host mask (B, S): int32, in order."""
    return np.flatnonzero(np.asarray(mask).reshape(-1)).astype(np.int32)


def forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: DeepseekEncoderConfig, *, tokens: torch.Tensor | None = None,
            counters: MoECounters | None = None, record: list | None = None) -> torch.Tensor:
    """Hidden states (B, S, H) after the final norm.

    tokens: the rows of the flattened batch whose tokens are routed (int32
    on the ids' device); `BatchedEncoder` passes the real rows' real
    tokens, read from its host mask. Without it every position the mask
    marks is routed, found on the device (a read back to the host on the
    card). counters: a `MoECounters` the expert layers add to. record: a
    list to which one (n_moe_layers, T, k) uint8 tensor of each layer's
    picks is appended (the arithmetic is unchanged)."""
    if torch.is_grad_enabled():
        raise ValueError("the deepseek tower runs inference only: call it under torch.no_grad() "
                         "or torch.inference_mode() (training is not supported)")
    from .sharding import is_sharded

    if is_sharded(params):
        raise ValueError("the deepseek tower has no tensor-parallel placement")
    b, s = input_ids.shape
    h = cfg.hidden_size
    dtype = _DTYPES[cfg.dtype]
    if tokens is None:
        tokens = attention_mask.reshape(-1).nonzero().flatten().to(torch.int32)
    tokens = tokens.to(input_ids.device, torch.int32)
    picks = None
    if record is not None:
        picks = torch.empty((cfg.n_moe_layers, tokens.numel(), cfg.num_experts_per_tok),
                            dtype=torch.uint8, device=input_ids.device)
        record.append(picks)
    x = params["embed"][input_ids.long()].to(dtype).contiguous()
    cos, sin = rope_tables(s, cfg.qk_rope_head_dim, cfg.rope_theta, x.device)
    eps = cfg.rms_norm_eps
    for li, layer in enumerate(params["layers"]):
        x = x + _attention(layer, _rms_norm(x, layer["attn_norm"], eps), cos, sin, cfg)
        m = _rms_norm(x, layer["mlp_norm"], eps)
        if "router" not in layer:
            x = x + _mlp(layer, m)
        elif tokens.numel():
            mi = li - cfg.first_k_dense_replace
            _moe_into(layer, m.view(b * s, h), x.view(b * s, h), tokens, cfg, counters,
                      picks[mi] if picks is not None else None)
    return _rms_norm(x, params["final_norm"], eps)


def encode_pooled(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  cfg: DeepseekEncoderConfig, *, tokens: torch.Tensor | None = None,
                  counters: MoECounters | None = None, record: list | None = None) -> torch.Tensor:
    """Pooled, L2-normalized embeddings (B, D) f32: the last real token."""
    hidden = forward(params, input_ids, attention_mask, cfg, tokens=tokens, counters=counters,
                     record=record)
    idx = torch.clamp(attention_mask.to(torch.int64).sum(dim=1) - 1, min=0)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx].float()
    if cfg.normalize:
        pooled = pooled / torch.clamp(pooled.norm(dim=-1, keepdim=True), min=1e-12)
    return pooled
