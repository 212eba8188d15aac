"""Port parity: the fused attention backward (plain version of kernel B7)
against the JAX reference's Pallas backward in interpret mode and against
jax.vjp of its XLA composition; the autograd Function's CPU backward; and
the encoder's gradients through the fused core."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.encoder.model import _make_attn_core
from theoremsearch_tpu.kernels.attention import fused_qknorm_rope_attention_bwd as j_bwd
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder.model import encode_pooled, init_params
from theoremsearch_tpu_torch.kernels.attention import (
    QKNormRopeAttention,
    attention_bwd_launches,
    fused_qknorm_rope_attention_bwd,
    fused_qknorm_rope_attention_bwd_plain,
    fused_qknorm_rope_attention_plain,
)

torch.set_num_threads(1)

DH = 128
EPS = 1e-6
# the encoder config of the port's head_dim-128 tests: EncoderConfig.tiny()
# has head_dim 32 and never reaches the fused core
CFG128 = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                       num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64,
                       embedding_dim=256)


def _inputs(b, s, h, hk, seed):
    """Ragged right padding with mask[:, 0] = 1, and the upstream gradient
    zeroed on padded rows (what last-token pooling sends back)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h * DH)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hk * DH)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, s, hk * DH)) * 0.5).astype(np.float32)
    qw = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    kw = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    pos = np.maximum(mask.cumsum(1) - 1, 0)
    inv = 1.0 / (1e6 ** (np.arange(0, DH, 2) / DH))
    ang = (pos[..., None] * inv).astype(np.float32)
    g = (rng.standard_normal((b, s, h * DH)) * mask[..., None]).astype(np.float32)
    return q, k, v, qw, kw, np.cos(ang), np.sin(ang), mask, g


def _bf16_np(a):
    """a rounded to bf16, back as f32: both sides see the same bf16 inputs."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _port(q, k, v, qw, kw, cos, sin, mask, g, h, hk):
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    t = torch.from_numpy
    return fused_qknorm_rope_attention_bwd(
        bf(q), bf(k), bf(v), t(qw), t(kw), t(cos), t(sin), t(mask), bf(g),
        num_heads=h, num_kv_heads=hk, head_dim=DH, eps=EPS)


def _close(a, b, rel, cos_min, tag):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
    assert cos > cos_min, (tag, cos)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), (tag, np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("b,s,h,hk", [(8, 32, 4, 2), (8, 16, 4, 2), (2, 128, 4, 2)])
def test_plain_bwd_matches_jax_kernel(b, s, h, hk):
    q, k, v, qw, kw, cos, sin, mask, g = _inputs(b, s, h, hk, seed=s + b)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = j_bwd(j(q), j(k), j(v), jnp.asarray(qw), jnp.asarray(kw), jnp.asarray(cos),
                jnp.asarray(sin), jnp.asarray(mask), j(g),
                num_heads=h, num_kv_heads=hk, head_dim=DH, eps=EPS, interpret=True)
    out = _port(q, k, v, qw, kw, cos, sin, mask, g, h, hk)
    for name, o, r in zip(("dq", "dk", "dv"), out[:3], ref[:3]):
        assert o.dtype == torch.bfloat16
        _close(o.float().numpy(), np.asarray(r, np.float32), 2e-2, 0.9999, name)
    for name, o, r in zip(("dqw", "dkw"), out[3:], ref[3:]):
        assert o.dtype == torch.float32 and o.shape == (DH,)
        _close(o.numpy(), np.asarray(r), 1e-3, 0.9999, name)


@pytest.mark.parametrize("b,s,h,hk", [(8, 32, 4, 2), (2, 128, 4, 2)])
def test_plain_bwd_matches_jax_vjp_of_reference_composition(b, s, h, hk):
    """Against jax.vjp of the XLA composition, at the reference's own
    tolerance for its kernel (tests/test_encoder.py)."""
    q, k, v, qw, kw, cos, sin, mask, g = _inputs(b, s, h, hk, seed=3 * s)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    core = _make_attn_core(h, hk, DH, EPS, True)
    _, vjp = jax.vjp(core._ref, j(q), j(k), j(v), jnp.asarray(qw), jnp.asarray(kw),
                     jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask))
    ref = vjp(j(g))[:5]
    out = _port(q, k, v, qw, kw, cos, sin, mask, g, h, hk)
    for name, o, r in zip(("dq", "dk", "dv", "dqw", "dkw"), out, ref):
        _close(o.float().numpy(), np.asarray(r, np.float32), 0.05, 0.999, name)
    assert np.abs(out[0].float().numpy()[mask == 0]).max(initial=0.0) < 1e-3


def test_function_backward_matches_autograd_of_plain_forward():
    """The Function's CPU backward (B7's plain version) against autograd
    through the plain forward, on the same bf16 inputs."""
    b, s, h, hk = 4, 32, 4, 2
    q, k, v, qw, kw, cos, sin, mask, g = _inputs(b, s, h, hk, seed=11)
    kw_ = dict(num_heads=h, num_kv_heads=hk, head_dim=DH, eps=EPS, causal=True, scale=DH ** -0.5)

    def leaves():
        return [torch.from_numpy(_bf16_np(a)).to(torch.bfloat16).requires_grad_() for a in (q, k, v)] + [
            torch.from_numpy(a.copy()).requires_grad_() for a in (qw, kw)]

    gt = torch.from_numpy(g).to(torch.bfloat16)
    rest = (torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(mask))
    a = leaves()
    out_a = QKNormRopeAttention.apply(*a, *rest, h, hk, DH, EPS, True, DH ** -0.5, False)
    out_a.backward(gt)
    # autograd through the plain forward differentiates its bf16 casts as
    # identities, where B7 rounds at the kernel's points: a direction check
    bl = leaves()
    out_b = fused_qknorm_rope_attention_plain(*bl, *rest, **kw_)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    out_b.backward(gt)
    for name, x, y in zip(("q", "k", "v", "q_norm", "k_norm"), a, bl):
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
        xa, ya = x.grad.double().flatten(), y.grad.double().flatten()
        cos_ = float(xa @ ya / (xa.norm() * ya.norm()))
        assert cos_ >= 0.999, (name, cos_)


def test_wrapper_routes_cpu_to_plain_and_checks_shapes():
    b, s, h, hk = 2, 16, 4, 2
    args = _inputs(b, s, h, hk, seed=5)
    before = attention_bwd_launches.n
    out = _port(*args, h, hk)
    assert attention_bwd_launches.n == before      # a CPU tensor launches nothing
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    t = torch.from_numpy
    q, k, v, qw, kw, cos, sin, mask, g = args
    plain = fused_qknorm_rope_attention_bwd_plain(
        bf(q), bf(k), bf(v), t(qw), t(kw), t(cos), t(sin), t(mask), bf(g),
        num_heads=h, num_kv_heads=hk, head_dim=DH, eps=EPS, causal=True, scale=DH ** -0.5)
    for x, y in zip(out, plain):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="head_dim 128"):
        fused_qknorm_rope_attention_bwd(
            bf(q), bf(k), bf(v), t(qw), t(kw), t(cos), t(sin), t(mask), bf(g),
            num_heads=3, num_kv_heads=2, head_dim=DH)


@pytest.mark.parametrize("fused", ["on", "plain"])
def test_encoder_grads_reach_every_attention_weight(fused):
    """encode_pooled through the fused core gives nonzero, finite
    gradients to every layer's wq, wk, wv, q_norm and k_norm."""
    params = init_params(CFG128, torch.Generator().manual_seed(0), device="cpu")
    leaves = [t for layer in params["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, 1024, (4, 32)))
    mask = torch.from_numpy((np.arange(32)[None] < np.array([32, 20, 9, 1])[:, None]).astype(np.int32))
    emb = encode_pooled(params, ids, mask, CFG128, fused=fused)
    (emb * torch.from_numpy(rng.standard_normal(emb.shape).astype(np.float32))).sum().backward()
    for li, layer in enumerate(params["layers"]):
        for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
            gr = layer[name].grad
            assert gr is not None, (li, name)
            assert bool(torch.isfinite(gr.float()).all()) and float(gr.float().abs().max()) > 0, (li, name)


def test_int8_layers_refuse_grad():
    """B3 and B4 have no backward: under grad, an input that requires grad
    raises instead of getting no gradient; inference mode runs."""
    from theoremsearch_tpu_torch.encoder.model import _rope_tables, quantize_params_int8
    from theoremsearch_tpu_torch.kernels.layer_int8 import fused_attn_int8_layer, fused_mlp_int8_layer

    params = init_params(CFG128, torch.Generator().manual_seed(0), device="cpu")
    layer = params["layers"][0]
    lq = quantize_params_int8(params)[0]
    x = torch.randn((2, 16, CFG128.hidden_size)).to(torch.bfloat16).requires_grad_()
    mask = torch.ones((2, 16), dtype=torch.int32)
    rope = _rope_tables(torch.clamp(mask.cumsum(1) - 1, min=0), DH, CFG128.rope_theta)
    with pytest.raises(ValueError, match="inference-only"):
        fused_mlp_int8_layer(x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
    with pytest.raises(ValueError, match="inference-only"):
        fused_attn_int8_layer(x, layer, lq, mask, rope, CFG128)
    with torch.inference_mode():
        assert fused_attn_int8_layer(x, layer, lq, mask, rope, CFG128).shape == x.shape
