"""The two towers as written in their model cards, in plain PyTorch.

qwen (Qwen3-Embedding): token embedding -> N x (RMSNorm -> attention with
per-head q/k RMSNorm, rotate-half RoPE, grouped kv heads, causal mask ->
residual -> RMSNorm -> SwiGLU -> residual) -> RMSNorm -> the last real
token -> L2 normalize.

bert (BERT-base, post-LayerNorm): word + position + type-0 embeddings ->
LayerNorm -> N x (biased q/k/v, bidirectional attention over real
tokens, biased output -> LayerNorm(x + .) -> Linear, exact GELU, Linear
-> LayerNorm(x + .)) -> mean over real tokens -> L2 normalize.

`mode` picks the arithmetic: "f32" (the reference: float32 throughout,
TF32 off); "bf16" (bfloat16 products with f32 accumulation, activations
rounded to bfloat16 between ops, norms and softmax in f32: the
benchmark's data maker); "int8" (the control: as "bf16", with every
product by a weight matrix in int8, weights per output column and
activations per token at absmax / 127, summed in float32). Sequences
are right-padded in blocks sorted by length; padding is masked out of
attention and pooling, so it changes no real token."""

from __future__ import annotations

import math

import numpy as np
import torch


class tf32_off:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _quant_rows(x: torch.Tensor):
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127), s


def _r(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x rounded to the activations' type of `mode`."""
    return x if mode == "f32" else x.to(torch.bfloat16).float()


def _linear(x: torch.Tensor, w: torch.Tensor, mode: str, bias=None) -> torch.Tensor:
    """x (..., in) f32 times w (in, out), in `mode`'s arithmetic."""
    if mode == "f32":
        y = x @ w.float()
    elif mode == "bf16":
        y = (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    elif mode == "int8":
        wf = w.float()
        sw = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 127.0
        wq = torch.clamp(torch.round(wf / sw), -127, 127)
        xq, sx = _quant_rows(x)
        y = (xq @ wq) * sx * sw
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return _r(y if bias is None else y + bias.float(), mode)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _ln(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _rope(x, pos, theta):
    """x (B, S, heads, Dh), rotate-half with inverse frequencies
    theta^(-2j / Dh)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (pos[..., None].double() * inv).float()
    c, s = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, allowed):
    """q (B, S, H, Dh), k/v (B, S, H, Dh), allowed (B, 1, S, S) bool."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def qwen_block(params, model, ids, mask, mode):
    b, s = ids.shape
    h, nh, nk, dh = (model["hidden_size"], model["num_attention_heads"],
                     model["num_key_value_heads"], model["head_dim"])
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    pos = torch.arange(s, device=ids.device)[None].expand(b, s)
    causal = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
    allowed = causal[None, None] & mask[:, None, None, :]
    x = _r(params["embed"][ids].float(), mode)
    for layer in params["layers"]:
        a = _r(_rms(x, layer["attn_norm"], eps), mode)
        q = _linear(a, layer["wq"], mode).view(b, s, nh, dh)
        k = _linear(a, layer["wk"], mode).view(b, s, nk, dh)
        v = _linear(a, layer["wv"], mode).view(b, s, nk, dh)
        q = _rope(_rms(q, layer["q_norm"], eps), pos, theta)
        k = _rope(_rms(k, layer["k_norm"], eps), pos, theta)
        rep = nh // nk
        o = _r(_attend(q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2),
                       allowed), mode)
        x = _r(x + _linear(o.reshape(b, s, nh * dh), layer["wo"], mode), mode)
        m = _r(_rms(x, layer["mlp_norm"], eps), mode)
        g = torch.nn.functional.silu(_linear(m, layer["w_gate"], mode))
        x = _r(x + _linear(_r(g * _linear(m, layer["w_up"], mode), mode), layer["w_down"], mode),
               mode)
    x = _rms(x, params["final_norm"], eps)
    last = mask.long().sum(dim=1) - 1
    return x[torch.arange(b, device=x.device), last]


def bert_block(params, model, ids, mask, mode):
    b, s = ids.shape
    h, nh = model["hidden_size"], model["num_attention_heads"]
    dh, eps = h // nh, model["layer_norm_eps"]
    allowed = mask[:, None, None, :].expand(b, 1, s, s)
    x = (params["embed"][ids].float() + params["pos_embed"][:s].float()[None]
         + params["type_embed"][0].float()[None, None])
    x = _r(_ln(_r(x, mode), params["embed_ln_g"], params["embed_ln_b"], eps), mode)
    for layer in params["layers"]:
        q, k, v = (_linear(x, layer[w], mode, layer[bn]).view(b, s, nh, dh)
                   for w, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        o = _r(_attend(q, k, v, allowed).reshape(b, s, h), mode)
        x = _r(_ln(x + _linear(o, layer["wo"], mode, layer["bo"]), layer["attn_ln_g"],
                   layer["attn_ln_b"], eps), mode)
        f = _linear(x, layer["w_in"], mode, layer["b_in"])
        f = _r(0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0))), mode)
        x = _r(_ln(x + _linear(f, layer["w_out"], mode, layer["b_out"]), layer["mlp_ln_g"],
                   layer["mlp_ln_b"], eps), mode)
    m = mask[:, :, None].float()
    return (x * m).sum(dim=1) / m.sum(dim=1)


def embed(params, model: dict, family: str, seqs: list[list[int]], mode: str = "f32",
          device=None, block_tokens: int = 32768) -> torch.Tensor:
    """L2-normalized embeddings (len(seqs), hidden) f32 of token-id
    sequences (specials included), in blocks of sequences sorted by length
    of about `block_tokens` padded tokens."""
    device = device or params["embed"].device
    fwd = {"qwen": qwen_block, "bert": bert_block}[family]
    out = torch.empty((len(seqs), model["hidden_size"]), dtype=torch.float32, device=device)
    order = np.argsort([len(t) for t in seqs], kind="stable")
    at = 0
    with torch.no_grad(), tf32_off():
        while at < len(order):
            # ascending lengths: the block's last sequence sets its width
            idx = [order[at]]
            at += 1
            while at < len(order) and (len(idx) + 1) * len(seqs[order[at]]) <= block_tokens:
                idx.append(order[at])
                at += 1
            width = len(seqs[idx[-1]])
            ids = torch.zeros((len(idx), width), dtype=torch.long)
            mask = torch.zeros((len(idx), width), dtype=torch.bool)
            for r, i in enumerate(idx):
                ids[r, : len(seqs[i])] = torch.tensor(seqs[i])
                mask[r, : len(seqs[i])] = True
            pooled = fwd(params, model, ids.to(device), mask.to(device), mode)
            out[torch.as_tensor(idx, device=device)] = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return out
