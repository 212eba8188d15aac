"""Fused encoder attention: QK-RMSNorm + RoPE + softmax(QK^T)V.

Port of theoremsearch_tpu/kernels/attention.py (the forward). The TPU
kernel `_attn_kernel` becomes the hand-written CUDA kernel in
`csrc/attention.cu`; `fused_qknorm_rope_attention_plain` is its plain
PyTorch version with the kernel's own casts (q scaled before its bf16
cast, k normed/rotated then cast, f32 logits and softmax, bf16 probs,
f32 P.V, bf16 out). A CPU tensor goes to the plain version, a CUDA tensor
to the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

attention_launches = LaunchCounter()


def fused_qknorm_rope_attention_plain(
    q, k, v, q_norm_w, k_norm_w, cos, sin, mask, *,
    num_heads: int, num_kv_heads: int, head_dim: int, eps: float, causal: bool,
    scale: float,
) -> torch.Tensor:
    """Plain version: (B, S, H*Dh) bf16 from the raw projections."""
    b, s, _ = q.shape
    h, hk, dh = num_heads, num_kv_heads, head_dim
    half = dh // 2
    c = cos.float()[:, :, None, :]
    sn = sin.float()[:, :, None, :]

    def norm_rope(x, w):
        var = (x * x).mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps) * w.float()
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)

    qh = (norm_rope(q.float().view(b, s, h, dh), q_norm_w) * scale).to(torch.bfloat16)
    kh = norm_rope(k.float().view(b, s, hk, dh), k_norm_w).to(torch.bfloat16)
    rep = h // hk
    kh = kh.repeat_interleave(rep, dim=2)
    vh = v.to(torch.bfloat16).view(b, s, hk, dh).repeat_interleave(rep, dim=2)
    valid = (mask != 0)[:, None, None, :]
    if causal:
        valid = valid & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        logits = logits + torch.where(valid, 0.0, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        probs = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vh.float())
    return out.to(torch.bfloat16).reshape(b, s, h * dh)


def fused_qknorm_rope_attention(
    q: torch.Tensor,        # (B, S, H*Dh) bf16 raw projections
    k: torch.Tensor,        # (B, S, Hk*Dh)
    v: torch.Tensor,        # (B, S, Hk*Dh)
    q_norm_w: torch.Tensor,  # (Dh,) f32
    k_norm_w: torch.Tensor,  # (Dh,) f32
    cos: torch.Tensor,      # (B, S, Dh//2) f32
    sin: torch.Tensor,      # (B, S, Dh//2) f32
    mask: torch.Tensor,     # (B, S) int/bool, 1 = real token
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    eps: float = 1e-6,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention block output (B, S, H*Dh) bf16 (before wo).
    The kernel takes head_dim 128 and S <= 128, the shapes the encoder
    dispatches to it (`encoder/model.py:_fused_ok`)."""
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(head_dim)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              eps=eps, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return fused_qknorm_rope_attention_plain(
            q, k, v, q_norm_w, k_norm_w, cos, sin, mask, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"fused_qknorm_rope_attention: unsupported device {q.device}")
    b, s, _ = q.shape
    if head_dim != 128 or not 1 <= s <= 128 or num_heads % num_kv_heads or b > 65535:
        raise ValueError(f"attention kernel takes head_dim 128, S <= 128; got {head_dim}, {s}")
    for name, t, width in (("q", q, num_heads), ("k", k, num_kv_heads), ("v", v, num_kv_heads)):
        if t.dtype != torch.bfloat16 or t.shape != (b, s, width * head_dim):
            raise ValueError(f"{name}: want bf16 {(b, s, width * head_dim)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    dev = q.device
    qw = q_norm_w.to(dev, torch.float32).contiguous()
    kw_ = k_norm_w.to(dev, torch.float32).contiguous()
    cs = cos.to(dev, torch.float32).contiguous()
    sn = sin.to(dev, torch.float32).contiguous()
    m = mask.to(dev, torch.int32).contiguous()
    if qw.shape != (head_dim,) or kw_.shape != (head_dim,):
        raise ValueError("norm weights must be (head_dim,)")
    if cs.shape != (b, s, head_dim // 2) or sn.shape != cs.shape or m.shape != (b, s):
        raise ValueError("cos/sin must be (B, S, Dh/2) and mask (B, S)")
    out = torch.empty_like(q)
    lib = load()
    err = lib.ts_qknorm_rope_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qw.data_ptr(), kw_.data_ptr(),
        cs.data_ptr(), sn.data_ptr(), m.data_ptr(), out.data_ptr(),
        b, s, num_heads, num_kv_heads, head_dim, float(eps), float(scale), int(causal),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    check(lib, err, "fused_qknorm_rope_attention")
    attention_launches.bump()
    return out
