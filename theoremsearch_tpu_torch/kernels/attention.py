"""Fused encoder attention: QK-RMSNorm + RoPE + softmax(QK^T)V, and its
backward.

Port of theoremsearch_tpu/kernels/attention.py. The TPU kernel
`_attn_kernel` (the forward, B2) becomes the hand-written CUDA kernel in
`csrc/attention.cu`; `fused_qknorm_rope_attention_plain` is its plain
PyTorch version with the kernel's own casts (q scaled before its bf16
cast, k normed/rotated then cast, f32 logits and softmax, bf16 probs,
f32 P.V, bf16 out). The TPU kernel `_attn_bwd_kernel` (the backward, B7)
becomes `csrc/attention_bwd.cu`, with `fused_qknorm_rope_attention_bwd_plain`
beside it. `QKNormRopeAttention` ties the two into one autograd Function,
which the encoder calls in training and serving alike. A CPU tensor goes
to the plain versions, a CUDA tensor to the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

attention_launches = LaunchCounter()          # the qwen form, head_dim 128
attention_gemma_launches = LaunchCounter()    # the gemma form, head_dim 256
attention_bwd_launches = LaunchCounter()


def qk_rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The q/k RMSNorm statistic r = rsqrt(mean(x^2) + eps) over the last
    axis, as B2, B7 and both plain versions take it: the squares of the
    bf16-valued f32 inputs summed in f64 and rounded to f32 once (each
    square is exact, so the sum is one f32 whatever its order), then
    rsqrt(ss / Dh + eps) in f32, the kernels' rsqrtf(ss / DH + eps). The
    reference's f32 `mean` is one rounding order among many; this one
    is the same in every kernel and in the plain versions."""
    xd = x.double()
    ss = (xd * xd).sum(dim=-1, keepdim=True).float()
    return torch.rsqrt(ss / x.shape[-1] + eps)


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
        x = x * qk_rms_inv(x, eps) * w.float()
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
    The kernel takes S <= 128 and head_dim 128 (the qwen form,
    `encoder/model.py:_fused_ok`) or 256 (the gemma form, bidirectional,
    `encoder/gemma.py:_fused_ok`); each form counts its own launches."""
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(head_dim)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              eps=eps, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return fused_qknorm_rope_attention_plain(
            q, k, v, q_norm_w, k_norm_w, cos, sin, mask, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"fused_qknorm_rope_attention: unsupported device {q.device}")
    b, s, _ = q.shape
    if head_dim not in (128, 256) or not 1 <= s <= 128 or num_heads % num_kv_heads or b > 65535:
        raise ValueError(f"attention kernel takes head_dim 128 or 256, S <= 128; got {head_dim}, {s}")
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
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_qknorm_rope_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qw.data_ptr(), kw_.data_ptr(),
            cs.data_ptr(), sn.data_ptr(), m.data_ptr(), out.data_ptr(),
            b, s, num_heads, num_kv_heads, head_dim, float(eps), float(scale), int(causal),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    check(lib, err, "fused_qknorm_rope_attention")
    (attention_gemma_launches if head_dim == 256 else attention_launches).bump()
    return out


def fused_qknorm_rope_attention_bwd_plain(
    q, k, v, q_norm_w, k_norm_w, cos, sin, mask, g, *,
    num_heads: int, num_kv_heads: int, head_dim: int, eps: float, causal: bool,
    scale: float,
) -> tuple[torch.Tensor, ...]:
    """Plain version of kernel B7: (dq, dk, dv) bf16 and (dqw, dkw) f32
    (Dh,), with the TPU kernel's steps and casts. The forward's
    intermediates are recomputed (q normed, rotated, scaled and cast to
    bf16; k normed, rotated, cast; f32 logits and softmax p; pb = bf16 p);
    then dv = pb^T g, dl = p (dp - rowsum(dp p)) with dp = g v^T, dlb =
    bf16 dl, dq_rot = (dlb k) scale and dk_rot = dlb^T q_scaled, through
    the rotation's transpose and the RMSNorm adjoint
    r (dxn - xn mean(dxn xn)), with dw = sum(dz xn)."""
    b, s, _ = q.shape
    h, hk, dh = num_heads, num_kv_heads, head_dim
    half = dh // 2
    rep = h // hk
    c = cos.float()[:, :, None, :]
    sn = sin.float()[:, :, None, :]
    qw, kw = q_norm_w.float(), k_norm_w.float()

    def parts(x, w):
        """(rotated output, normalized-before-weight xn, r), all f32."""
        r = qk_rms_inv(x, eps)
        xn = x * r
        z = xn * w
        z1, z2 = z[..., :half], z[..., half:]
        return torch.cat([z1 * c - z2 * sn, z2 * c + z1 * sn], dim=-1), xn, r

    def rope_t(d):
        d1, d2 = d[..., :half], d[..., half:]
        return torch.cat([d1 * c + d2 * sn, d2 * c - d1 * sn], dim=-1)

    def norm_bwd(dz, xn, r, w):
        dxn = dz * w
        dw = (dz * xn).sum(dim=(0, 1, 2))
        proj = (dxn * xn).sum(dim=-1, keepdim=True) / dh
        return r * (dxn - xn * proj), dw

    qy, xn_q, r_q = parts(q.float().view(b, s, h, dh), qw)
    qh = (qy * scale).to(torch.bfloat16).float()
    ky, xn_k, r_k = parts(k.float().view(b, s, hk, dh), kw)
    kh = ky.to(torch.bfloat16).float().repeat_interleave(rep, dim=2)
    vh = v.to(torch.bfloat16).float().view(b, s, hk, dh).repeat_interleave(rep, dim=2)
    gh = g.to(torch.bfloat16).float().view(b, s, h, dh)
    valid = (mask != 0)[:, None, None, :]
    if causal:
        valid = valid & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) + torch.where(valid, 0.0, -1e30)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        pb = p.to(torch.bfloat16).float()
        dv = torch.einsum("bhqk,bqhd->bkhd", pb, gh).view(b, s, hk, rep, dh).sum(dim=3)
        dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
        dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dlb = dl.to(torch.bfloat16).float()
        dqy = torch.einsum("bhqk,bkhd->bqhd", dlb, kh) * scale
        dkn = torch.einsum("bhqk,bqhd->bkhd", dlb, qh).view(b, s, hk, rep, dh).sum(dim=3)
    dxq, dqw = norm_bwd(rope_t(dqy), xn_q, r_q, qw)
    dxk, dkw = norm_bwd(rope_t(dkn), xn_k, r_k, kw)
    bf = torch.bfloat16
    return (dxq.to(bf).reshape(b, s, h * dh), dxk.to(bf).reshape(b, s, hk * dh),
            dv.to(bf).reshape(b, s, hk * dh), dqw, dkw)


def fused_qknorm_rope_attention_bwd(
    q: torch.Tensor,        # (B, S, H*Dh) bf16 raw projections
    k: torch.Tensor,        # (B, S, Hk*Dh)
    v: torch.Tensor,        # (B, S, Hk*Dh)
    q_norm_w: torch.Tensor,  # (Dh,) f32
    k_norm_w: torch.Tensor,  # (Dh,) f32
    cos: torch.Tensor,      # (B, S, Dh//2) f32
    sin: torch.Tensor,      # (B, S, Dh//2) f32
    mask: torch.Tensor,     # (B, S) int/bool, 1 = real token
    g: torch.Tensor,        # (B, S, H*Dh) upstream gradient
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    eps: float = 1e-6,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dqw, dkw) of fused_qknorm_rope_attention: kernel B7
    for CUDA tensors, its plain version for CPU ones. Nothing is saved
    from the forward; the kernel recomputes it. Shapes as the forward's:
    head_dim 128, S <= 128, H a multiple of Hk. dqw and dkw come back f32
    (Dh,), summed over the batch in a fixed order (two launches on the
    same inputs give bit-equal outputs)."""
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(head_dim)
    b, s, _ = q.shape
    if head_dim != 128 or not 1 <= s <= 128 or num_heads % num_kv_heads or b > 65535:
        raise ValueError(f"attention backward takes head_dim 128, S <= 128 and H a multiple "
                         f"of Hk; got head_dim {head_dim}, S {s}, H/Hk {num_heads}/{num_kv_heads}")
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              eps=eps, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return fused_qknorm_rope_attention_bwd_plain(
            q, k, v, q_norm_w, k_norm_w, cos, sin, mask, g, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"fused_qknorm_rope_attention_bwd: unsupported device {q.device}")
    for name, t, width in (("q", q, num_heads), ("k", k, num_kv_heads), ("v", v, num_kv_heads),
                           ("g", g, num_heads)):
        if t.dtype != torch.bfloat16 or t.shape != (b, s, width * head_dim):
            raise ValueError(f"{name}: want bf16 {(b, s, width * head_dim)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    dev = q.device

    def f32_aligned(t):   # the kernel reads these in 16-byte pieces
        t = t.to(dev, torch.float32).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    qw, kw_, cs, sn = (f32_aligned(t) for t in (q_norm_w, k_norm_w, cos, sin))
    m = mask.to(dev, torch.int32).contiguous()
    if qw.shape != (head_dim,) or kw_.shape != (head_dim,):
        raise ValueError("norm weights must be (head_dim,)")
    if cs.shape != (b, s, head_dim // 2) or sn.shape != cs.shape or m.shape != (b, s):
        raise ValueError("cos/sin must be (B, S, Dh/2) and mask (B, S)")
    q, k, v, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per-block partial sums of the norm-weight gradients, summed in a
    # fixed order by the second launch
    partial = torch.empty((2, b * num_kv_heads, head_dim), dtype=torch.float32, device=dev)
    dqw = torch.empty((head_dim,), dtype=torch.float32, device=dev)
    dkw = torch.empty((head_dim,), dtype=torch.float32, device=dev)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_qknorm_rope_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qw.data_ptr(), kw_.data_ptr(),
            cs.data_ptr(), sn.data_ptr(), m.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
            dqw.data_ptr(), dkw.data_ptr(),
            b, s, num_heads, num_kv_heads, head_dim, float(eps), float(scale), int(causal),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    check(lib, err, "fused_qknorm_rope_attention_bwd")
    attention_bwd_launches.bump()
    return dq, dk, dv, dqw, dkw


class QKNormRopeAttention(torch.autograd.Function):
    """The fused attention core with its gradient: kernel B2 forward and
    kernel B7 backward (their plain versions for CPU tensors or
    plain=True), the counterpart of the reference's custom VJP
    (theoremsearch_tpu/encoder/model.py:_make_attn_core). Only the
    inputs are saved; the backward recomputes the rest. cos, sin and the
    mask get no gradient: nothing upstream of them is a parameter.

        QKNormRopeAttention.apply(q, k, v, q_norm_w, k_norm_w, cos, sin, mask,
                                  num_heads, num_kv_heads, head_dim, eps, causal,
                                  scale, plain)
    """

    @staticmethod
    def forward(ctx, q, k, v, q_norm_w, k_norm_w, cos, sin, mask,
                num_heads, num_kv_heads, head_dim, eps, causal, scale, plain):
        kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
                  eps=eps, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, q_norm_w, k_norm_w, cos, sin, mask)
        ctx.kw, ctx.plain = kw, plain
        if plain:
            return fused_qknorm_rope_attention_plain(q, k, v, q_norm_w, k_norm_w, cos, sin, mask, **kw)
        return fused_qknorm_rope_attention(q, k, v, q_norm_w, k_norm_w, cos, sin, mask, **kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qw, kw, cos, sin, mask = ctx.saved_tensors
        bwd = fused_qknorm_rope_attention_bwd_plain if ctx.plain else fused_qknorm_rope_attention_bwd
        dq, dk, dv, dqw, dkw = bwd(q, k, v, qw, kw, cos, sin, mask,
                                   g.to(torch.bfloat16).contiguous(), **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dqw.to(qw.dtype), dkw.to(kw.dtype),
                None, None, None, None, None, None, None, None, None, None)
