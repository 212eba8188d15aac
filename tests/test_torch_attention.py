"""Port parity: the fused QK-norm + RoPE attention (plain version of the
CUDA kernel) against the JAX reference's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.kernels.attention import fused_qknorm_rope_attention as j_attn
from theoremsearch_tpu_torch.kernels.attention import (
    fused_qknorm_rope_attention,
    fused_qknorm_rope_attention_plain,
)

torch.set_num_threads(1)

H, HK, DH, B = 4, 2, 128, 8


def _inputs(s, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, s, H * DH)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, s, HK * DH)) * 2).astype(np.float32)
    v = rng.standard_normal((B, s, HK * DH)).astype(np.float32)
    qw = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    kw = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    lens = rng.integers(1, s + 1, B)          # ragged right padding
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    pos = np.maximum(mask.cumsum(1) - 1, 0)
    inv = 1.0 / (1e6 ** (np.arange(0, DH, 2) / DH))
    ang = (pos[..., None] * inv).astype(np.float32)
    return q, k, v, qw, kw, np.cos(ang), np.sin(ang), mask


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("s", [16, 32, 128])
def test_plain_attention_matches_jax_kernel(s):
    q, k, v, qw, kw, cos, sin, mask = _inputs(s, seed=s)
    ref = np.asarray(j_attn(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(qw), jnp.asarray(kw), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask),
        num_heads=H, num_kv_heads=HK, head_dim=DH, interpret=True,
    )).astype(np.float64)
    out = fused_qknorm_rope_attention(
        _bf16(q), _bf16(k), _bf16(v), torch.from_numpy(qw), torch.from_numpy(kw),
        torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(mask),
        num_heads=H, num_kv_heads=HK, head_dim=DH,
    )
    assert out.dtype == torch.bfloat16 and out.shape == (B, s, H * DH)
    o = out.float().numpy().astype(np.float64)
    # bf16 casts land on either side of a rounding boundary when the f32
    # sums differ in order: a tolerance, not bit-equality
    cos_sim = float(o.ravel() @ ref.ravel() / (np.linalg.norm(o) * np.linalg.norm(ref)))
    assert cos_sim > 0.9999, cos_sim
    assert np.abs(o - ref).max() <= 1e-2 * np.abs(ref).max()


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, k, v, qw, kw, cos, sin, mask = _inputs(32, seed=7)
    args = (_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(qw), torch.from_numpy(kw),
            torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(mask))
    kw_ = dict(num_heads=H, num_kv_heads=HK, head_dim=DH, eps=1e-6, causal=True)
    a = fused_qknorm_rope_attention(*args, **kw_)
    b = fused_qknorm_rope_attention_plain(*args, scale=1.0 / np.sqrt(DH), **kw_)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dh", [128, 256])
def test_qk_rms_statistic_is_order_free_f64_sum(dh):
    """The q/k RMS statistic of B2, B7 and their plain versions: the f64
    sum of the squares of bf16 values, rounded to f32 once, then
    rsqrt(ss / Dh + eps) in f32. Permuting a row's columns gives a
    bit-equal r, and the sum equals numpy's f64 sum rounded to f32."""
    from theoremsearch_tpu_torch.kernels.attention import qk_rms_inv

    rng = np.random.default_rng(dh)
    x = _bf16((rng.standard_normal((64, dh)) * np.exp(rng.standard_normal((64, 1)) * 3))
              .astype(np.float32)).float()
    eps = 1e-6
    r = qk_rms_inv(x, eps)
    assert r.dtype == torch.float32 and r.shape == (64, 1)
    for seed in range(4):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(dh))
        assert torch.equal(qk_rms_inv(x[:, perm], eps), r)
    xn = x.numpy().astype(np.float64)
    ss = (xn * xn).sum(axis=1, keepdims=True).astype(np.float32)
    want = torch.rsqrt(torch.from_numpy(ss) / dh + eps)
    assert torch.equal(r, want)
