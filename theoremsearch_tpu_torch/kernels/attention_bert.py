"""BERT's attention core: masked softmax(q k^T / sqrt(64)) v over heads of
64, bidirectional, under a padding-only mask (`encoder/bert.py`).

The JAX package has no kernel here: it runs BERT on its XLA composition,
which the port keeps as `encoder/bert.py:_attention_core` (fused="off",
and training). `bert_attention` launches the hand-written CUDA kernel in
`csrc/attention_bert.cu` for CUDA tensors and runs its plain version,
`bert_attention_plain`, for CPU ones. Both take the projections before
their bias adds and the biases (or q, k and v with the biases added and
no `bias`), and round where the composition rounds: q, k and v + bias in
bf16, f32 logits and softmax over the whole key row, the probabilities
normalized and then cast to bf16, P V summed in f32, the output in bf16.
Both write 0 on padded query rows, which the pooling multiplies by 0.
The kernel has no backward.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

HEAD_DIM = 64
MAX_S = 512

attention_bert_launches = LaunchCounter()


def bert_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                         num_heads: int, bias=None) -> torch.Tensor:
    """Plain version of the kernel: (B, S, H * Dh) bf16 from (B, S, H * Dh)
    q, k, v and the (B, S) mask (1 = real token); `bias` (bq, bk, bv) is
    added as `x + b.to(bf16)`. The kernel's steps: f32 logits of the bf16
    values over sqrt(Dh), -1e30 at padded keys, e = exp(l - max), p =
    bf16(e * (1 / sum e)), out = bf16(p V) summed in f32, 0 on padded
    query rows."""
    b, s, width = q.shape
    dh = width // num_heads
    bf = torch.bfloat16
    if bias is not None:
        q, k, v = (x.to(bf) + bb.to(bf) for x, bb in zip((q, k, v), bias))
    q, k, v = (t.to(bf).reshape(b, s, num_heads, dh) for t in (q, k, v))
    real = mask.bool()
    with tf32_off():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(dh)
        logits = torch.where(real[:, None, None, :], logits, -1e30)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(bf)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(bf)
    out = torch.where(real[:, :, None, None], out, torch.zeros((), dtype=bf, device=out.device))
    return out.reshape(b, s, width)


def bert_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                   num_heads: int, bias=None) -> torch.Tensor:
    """The attention core (B, S, H * 64) bf16, in the layout wo reads: the
    kernel for CUDA tensors (head_dim 64, S <= 512, bf16 q/k/v, f32 or
    bf16 biases), the plain version for CPU ones. Each launch counts in
    `attention_bert_launches`."""
    if q.device.type == "cpu":
        return bert_attention_plain(q, k, v, mask, num_heads=num_heads, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"bert_attention: unsupported device {q.device}")
    b, s, width = q.shape
    if width != num_heads * HEAD_DIM or not 1 <= s <= MAX_S or b > 65535 or num_heads > 65535:
        raise ValueError(f"bert_attention takes heads of {HEAD_DIM} at S <= {MAX_S}; got "
                         f"{num_heads} heads in {width} columns at S {s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{name}: want bf16 {tuple(q.shape)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    dev = q.device
    # the kernel copies q, k and v in 16-byte pieces
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    m = mask.to(dev, torch.int32).contiguous()
    if m.shape != (b, s):
        raise ValueError(f"mask must be (B, S) = {(b, s)}, got {tuple(m.shape)}")
    biases = [None] * 3 if bias is None else [x.to(dev, torch.float32).contiguous() for x in bias]
    if any(x is not None and x.shape != (width,) for x in biases):
        raise ValueError(f"biases must be ({width},)")
    out = torch.empty_like(q)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_bert_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(None if x is None else x.data_ptr() for x in biases),
            m.data_ptr(), out.data_ptr(), b, s, num_heads,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    check(lib, err, "bert_attention")
    attention_bert_launches.bump()
    return out
