"""Moonlight-16B-A3B's block (DeepSeek-V3; HF `modeling_deepseek.py`) as
written, in plain PyTorch, used as an embedder: token embedding -> N x
(RMSNorm -> latent attention -> residual -> RMSNorm -> FFN -> residual)
-> RMSNorm -> the last real token -> L2 normalize.

Latent attention (q_lora_rank null): q = x W_q, each head [q_nope | q_pe];
x W_kv_a = [c_kv | k_pe] with one k_pe for all heads; kv = RMSNorm(c_kv)
W_kv_b, each head [k_nope | v]; q_pe and k_pe rotated as HF does it
(`view(..., d / 2, 2).transpose(4, 3)`, then rotate-half with cos and sin
of cat(freqs, freqs), freqs_j = pos theta^(-2j / d)); softmax over
[q_nope | q_pe] . [k_nope | k_pe] / sqrt(nope + rope), causal and over real
keys, times v; W_o.

FFN: the first `first_k_dense_replace` layers a SwiGLU; the rest a
mixture of experts: scores = sigmoid(x W_gate^T) in f32; the top
`num_experts_per_tok` of scores + e_score_correction_bias (one group:
n_group 1); weights = the picks' scores over their sum (+1e-20), times
`routed_scaling_factor`; out = sum of the picks' SwiGLUs, weighted, plus
the shared experts' SwiGLU (width n_shared x moe_intermediate).

`mode` is `towers.py`'s ("f32": the reference, float32 with TF32 off;
"bf16"; "int8": the control, every product by a weight matrix in int8,
the router's too). Each float32 weight is made when it is used and freed
after, so the reference runs beside the bf16 weights on one card. `route`
forces the picks: one (n_moe_layers, len, k) integer tensor a sequence,
which replaces the reference's own top k at the sequence's real tokens
(their weights still come from the reference's own scores). `diag`, a
list, receives one (n_moe_layers, len, E) float32 CPU tensor a sequence:
the reference's biased scores, score + bias, at each real token.

Parameters are the benchmark's plain data (`portbench/deepseek.py`):
dense matrices (in, out); expert matrices (E, out, in); the router (E, H)
f32. Nothing of the port is imported."""

from __future__ import annotations

import numpy as np
import torch

from .towers import _attend, _linear, _quant_rows, _r, _rms, tf32_off


def _rope_hf(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, d) as HF's apply_rotary_pos_emb leaves it."""
    b, s, nh, d = x.shape
    x = x.view(b, s, nh, d // 2, 2).transpose(4, 3).reshape(b, s, nh, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    freqs = (pos[..., None].double() * inv).float()
    emb = torch.cat([freqs, freqs], dim=-1)
    c, s_ = torch.cos(emb)[:, :, None, :], torch.sin(emb)[:, :, None, :]
    rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
    return x * c + rot * s_


def _swiglu(x, wg, wu, wd, mode):
    g = torch.nn.functional.silu(_linear(x, wg, mode))
    return _linear(_r(g * _linear(x, wu, mode), mode), wd, mode)


def _router_logits(x, router, mode):
    """x (N, H) times the router (E, H)^T: f32 (the published gate), or the
    int8 product of the control."""
    if mode != "int8":
        return x @ router.float().T
    w = router.float().T
    sw = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / sw), -127, 127)
    xq, sx = _quant_rows(x)
    return (xq @ wq) * sx * sw


def _moe(layer, model, m, real, forced, mode, diag):
    """The expert layer on m (B, S, H); real (B, S) bool; forced (B, S, k)
    or None."""
    b, s, h = m.shape
    k, n_e = model["num_experts_per_tok"], model["n_routed_experts"]
    flat = m.reshape(-1, h)
    scores = torch.sigmoid(_router_logits(flat, layer["router"], mode))
    biased = scores + layer["router_bias"].float()
    top = torch.topk(biased, k, dim=-1).indices
    if forced is not None:
        top = torch.where(real.reshape(-1, 1), forced.reshape(-1, k).long(), top)
    if diag is not None:
        diag.append(biased.view(b, s, n_e))
    w = scores.gather(1, top)
    if model["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * model["routed_scaling_factor"]
    routed = torch.zeros_like(flat)
    for e in range(n_e):
        hit = top == e
        rows = hit.any(dim=1).nonzero().flatten()
        if rows.numel() == 0:
            continue
        we = (w * hit).sum(dim=1)[rows, None]
        ye = _swiglu(flat[rows], layer["experts_gate"][e].T, layer["experts_up"][e].T,
                     layer["experts_down"][e].T, mode)
        routed[rows] += we * ye
    sh = layer["shared"]
    shared = _swiglu(flat, sh["w_gate"], sh["w_up"], sh["w_down"], mode)
    return _r(_r(routed, mode) + shared, mode).view(b, s, h)


def block(params, model, ids, mask, mode, forced=None, diag=None):
    """Pooled hidden states (B, H) of right-padded ids (B, S); forced
    (B, n_moe, S, k) or None."""
    b, s = ids.shape
    nh, r = model["num_attention_heads"], model["kv_lora_rank"]
    dn, dr, dv = model["qk_nope_head_dim"], model["qk_rope_head_dim"], model["v_head_dim"]
    eps, theta = model["rms_norm_eps"], float(model["rope_theta"])
    dense = model["first_k_dense_replace"]
    pos = torch.arange(s, device=ids.device)[None].expand(b, s)
    causal = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
    allowed = causal[None, None] & mask[:, None, None, :]
    x = _r(params["embed"][ids].float(), mode)
    for li, layer in enumerate(params["layers"]):
        a = _r(_rms(x, layer["attn_norm"], eps), mode)
        q = _linear(a, layer["wq"], mode).view(b, s, nh, dn + dr)
        kva = _linear(a, layer["wkv_a"], mode)
        c_kv, k_pe = kva[..., :r], kva[..., r:]
        kv = _linear(_r(_rms(c_kv, layer["kv_norm"], eps), mode), layer["wkv_b"], mode)
        kv = kv.view(b, s, nh, dn + dv)
        q_pe = _rope_hf(q[..., dn:], pos, theta)
        k_pe = _rope_hf(k_pe.reshape(b, s, 1, dr), pos, theta).expand(b, s, nh, dr)
        qf = torch.cat([q[..., :dn], q_pe], dim=-1)
        kf = torch.cat([kv[..., :dn], k_pe], dim=-1)
        o = _r(_attend(qf, kf, kv[..., dn:], allowed), mode)
        x = _r(x + _linear(o.reshape(b, s, nh * dv), layer["wo"], mode), mode)
        m = _r(_rms(x, layer["mlp_norm"], eps), mode)
        if li < dense:
            f = _swiglu(m, layer["w_gate"], layer["w_up"], layer["w_down"], mode)
        else:
            f = _moe(layer, model, m, mask, None if forced is None else forced[:, li - dense],
                     mode, diag)
        x = _r(x + f, mode)
    x = _rms(x, params["final_norm"], eps)
    last = mask.long().sum(dim=1) - 1
    return x[torch.arange(b, device=x.device), last]


def embed(params, model: dict, seqs: list[list[int]], mode: str = "f32", device=None,
          route: list | None = None, diag: list | None = None,
          block_tokens: int = 32768) -> torch.Tensor:
    """L2-normalized embeddings (len(seqs), hidden) f32 of token-id
    sequences (specials included), in blocks of sequences sorted by length
    of about `block_tokens` padded tokens; `route` and `diag` as in the
    module's note (diag's entries in the order of seqs)."""
    device = device or params["embed"].device
    n_moe = model["num_hidden_layers"] - model["first_k_dense_replace"]
    k = model["num_experts_per_tok"]
    out = torch.empty((len(seqs), model["hidden_size"]), dtype=torch.float32, device=device)
    got: dict[int, torch.Tensor] = {}
    order = np.argsort([len(t) for t in seqs], kind="stable")
    at = 0
    with torch.no_grad(), tf32_off():
        while at < len(order):
            idx = [order[at]]
            at += 1
            while at < len(order) and (len(idx) + 1) * len(seqs[order[at]]) <= block_tokens:
                idx.append(order[at])
                at += 1
            width = len(seqs[idx[-1]])
            ids = torch.zeros((len(idx), width), dtype=torch.long)
            mask = torch.zeros((len(idx), width), dtype=torch.bool)
            forced = None if route is None else torch.zeros((len(idx), n_moe, width, k),
                                                            dtype=torch.long)
            for j, i in enumerate(idx):
                n = len(seqs[i])
                ids[j, :n] = torch.tensor(seqs[i])
                mask[j, :n] = True
                if route is not None:
                    forced[j, :, :n] = torch.as_tensor(route[i]).long().cpu()
            scores = [] if diag is not None else None
            pooled = block(params, model, ids.to(device), mask.to(device), mode,
                           None if forced is None else forced.to(device), scores)
            out[torch.as_tensor(idx, device=device)] = (
                pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12))
            if scores is not None:
                per = torch.stack(scores, dim=1).cpu() if scores else None   # (B, n_moe, S, E)
                for j, i in enumerate(idx):
                    got[int(i)] = per[j, :, : len(seqs[i])] if per is not None else None
    if diag is not None:
        diag.extend(got[i] for i in range(len(seqs)))
    return out
