"""Port parity: the int8 (w8a8) encoder blocks (kernels B3 and B4 via
their plain versions on the CPU) and the int8 quantization stages
against the JAX package, on a small head_dim-128 config.

The reference's whole-layer kernels run in Pallas interpret mode. Its
jitted functions compute `m / 127` as `m * f32(1/127)`; the port follows
the jitted form, so comparisons are against `jax.jit` of the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.encoder import model as JM
from theoremsearch_tpu.kernels import layer_int8 as JL
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder import model as M
from theoremsearch_tpu_torch.kernels import layer_int8 as L

torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=64, embedding_dim=256)
B, S = 8, 32


def _cos(a, b) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def carried():
    """JAX params and their jitted int8 weights, and both carried over."""
    jcfg, cfg = JEncoderConfig(**SMALL), EncoderConfig(**SMALL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    jq = jax.jit(JM.quantize_params_int8)(jp)
    tp = M.params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, cfg, jp, jq, tp, M.quantize_params_int8(tp)


def _inputs(seed, d=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lens = rng.integers(4, S, B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return (jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16), mask)


def _rope(jcfg, mask):
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    jrc = JM._rope_tables(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    return jrc, tuple(torch.from_numpy(np.array(t)) for t in jrc)


def test_quantize_params_int8_bit_equal_to_jitted_jax(carried):
    _, _, _, jq, _, tq = carried
    assert len(tq) == SMALL["num_layers"]
    for jl, tl in zip(jq, tq):
        assert set(tl) == set(M._QUANT_KEYS)
        for k in M._QUANT_KEYS:
            assert tl[k]["q"].dtype == torch.int8 and tl[k]["s"].dtype == torch.float32
            np.testing.assert_array_equal(tl[k]["q"].numpy(), np.asarray(jl[k]["q"]))
            np.testing.assert_array_equal(tl[k]["s"].numpy(), np.asarray(jl[k]["s"]))


@pytest.mark.parametrize("w_offset", [0.0, 1.0])
def test_rmsnorm_quant_codes_match_jitted_jax(w_offset):
    """Scales within 2 ulp and codes equal but for rare +-1 flips: the
    reference sums the squares in f32 in XLA's order, the port in f64
    (so that the kernel and its plain version agree bit for bit); a
    one-ulp change of the row's rsqrt moves a code whose value lies that
    close to a rounding midpoint. At most 1 in 1000 codes may flip."""
    xj, xt, _ = _inputs(1)
    w = (0.1 * np.random.default_rng(2).standard_normal(256)).astype(np.float32)
    w = w if w_offset else w + 1.0
    jfn = jax.jit(JM._rmsnorm_quant_act, static_argnums=(2, 3))
    qj, sj = jfn(xj, jnp.asarray(w), 1e-6, w_offset)
    qt, st = M._rmsnorm_quant_act(xt, torch.from_numpy(w), 1e-6, w_offset)
    assert qt.dtype == torch.int8 and st.shape == (B, S, 1)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2.4e-7, atol=0)
    diff = qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= qt.numel() // 1000, np.count_nonzero(diff)


def test_quant_act_bit_equal_to_jitted_jax():
    xj, xt, _ = _inputs(3)
    xj, xt = xj * 3, xt * 3
    qj, sj = jax.jit(JM._quant_act)(xj)
    qt, st = M._quant_act(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("rows", ["b8s32", "t70"])
def test_mlp_layer_matches_jax_interpret(carried, rows):
    """B4's plain version vs the reference kernel in interpret mode, at
    B*S = 256 and at T = 70 (the reference's zero-pad branch): cosine >
    0.9999, the reference's own gate (kernels/layer_int8.py:35)."""
    jcfg, _, jp, jq, tp, tq = carried
    xj, xt, _ = _inputs(5)
    if rows == "t70":
        xj, xt = xj[:3].reshape(-1, 256)[:70], xt[:3].reshape(-1, 256)[:70]
    jl, tl = jq[0], tq[0]
    ref = JL.fused_mlp_int8_layer(xj, jp["layers"][0]["mlp_norm"], jl["w_gate"], jl["w_up"],
                                  jl["w_down"], eps=jcfg.rms_norm_eps, interpret=True)
    out = L.fused_mlp_int8_layer(xt, tp["layers"][0]["mlp_norm"], tl["w_gate"], tl["w_up"],
                                 tl["w_down"], eps=jcfg.rms_norm_eps)
    assert out.shape == xt.shape and out.dtype == torch.bfloat16
    assert _cos(ref, _f32(out)) > 0.9999


@pytest.mark.parametrize("layer", [0, 1])
def test_attn_layer_matches_jax_interpret(carried, layer):
    jcfg, cfg, jp, jq, tp, tq = carried
    xj, xt, mask = _inputs(6 + layer)
    jrc, trc = _rope(jcfg, mask)
    ref = JL.fused_attn_int8_layer(xj, jp["layers"][layer], jq[layer], jnp.asarray(mask), jrc,
                                   jcfg, interpret=True)
    out = L.fused_attn_int8_layer(xt, tp["layers"][layer], tq[layer], torch.from_numpy(mask),
                                  trc, cfg)
    assert out.shape == (B, S, 256) and out.dtype == torch.bfloat16
    assert _cos(ref, _f32(out)) > 0.9999


@pytest.mark.parametrize("use_fused", [False, True])
def test_op_chain_blocks_match_jax(carried, use_fused):
    """The int8 op-chain's blocks (the route for shapes the whole-layer
    kernels do not take) vs the reference's jitted chain, block by block
    on the same input: cosine > 0.9999."""
    jcfg, cfg, jp, jq, tp, tq = carried
    xj, xt, mask = _inputs(8)
    jrc, trc = _rope(jcfg, mask)
    jattn = jax.jit(functools.partial(JM._attention_int8, cfg=jcfg, use_fused=use_fused,
                                      interpret=True))
    ref = jattn(jp["layers"][0], jq[0], xj, jnp.asarray(mask), jrc)
    out = M._attention_int8(tp["layers"][0], tq[0], xt, torch.from_numpy(mask), trc, cfg,
                            use_fused, plain=False)
    assert _cos(ref, _f32(out)) > 0.9999
    jmlp = jax.jit(JM._mlp_int8, static_argnums=3)
    ref = jmlp(jp["layers"][1], jq[1], xj, jcfg.rms_norm_eps)
    out = M._mlp_int8(tp["layers"][1], tq[1], xt, cfg.rms_norm_eps)
    assert _cos(ref, _f32(out)) > 0.9999


def test_plain_whole_layers_equal_the_op_chain(carried):
    """The whole-layer plain versions are the op-chain's arithmetic with
    the residual add folded in: bit-equal."""
    jcfg, cfg, _, _, tp, tq = carried
    _, xt, mask = _inputs(9)
    _, trc = _rope(jcfg, mask)
    layer, lq = tp["layers"][0], tq[0]
    m = torch.from_numpy(mask)
    a = L.fused_attn_int8_layer_plain(xt, layer, lq, m, trc, cfg)
    torch.testing.assert_close(a, xt + M._attention_int8(layer, lq, xt, m, trc, cfg, True, True),
                               rtol=0, atol=0)
    b = L.fused_mlp_int8_layer_plain(a, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"],
                                     eps=cfg.rms_norm_eps)
    torch.testing.assert_close(b, a + M._mlp_int8(layer, lq, a, cfg.rms_norm_eps), rtol=0, atol=0)


@pytest.mark.parametrize("dims,want", [
    ((1024, 3072, 2048, 1024), True),     # qwen 0.6B
    ((768, 1152, 768, 256), True),        # gemma 300m
    ((2560, 9728, 2560, 1024), False),    # Qwen3-4B class: 75 MB of MLP weights
    ((1000, 3072, 2048, 1024), False),    # misaligned
])
def test_fused_layer_shapes_ok_truth_table(dims, want):
    assert L.fused_layer_shapes_ok(*dims) is want
    assert JL.fused_layer_shapes_ok(*dims) is want


def test_fused_layer_ok_wiring():
    """The attention-core rule and the shape rule together, as the
    reference routes them (tests/test_encoder.py:347-362)."""
    big = dict(vocab_size=512, hidden_size=2560, intermediate_size=9728, num_layers=1,
               num_heads=20, num_kv_heads=4, head_dim=128, max_seq_len=64, embedding_dim=256)
    for cfg, jcfg, want in ((EncoderConfig(**big), JEncoderConfig(**big), False),
                            (EncoderConfig(**SMALL), JEncoderConfig(**SMALL), True)):
        assert M._fused_ok(cfg, 16, 8) and JM._fused_ok(jcfg, 16, 8)
        assert M._fused_layer_ok(cfg, 16, 8) is want is JM._fused_layer_ok(jcfg, 16, 8)
    # the packing rule: S = 13 packs 9 items, and 8 is no multiple of 9
    assert not M._fused_layer_ok(EncoderConfig(**SMALL), 13, 8)
    assert not JM._fused_layer_ok(JEncoderConfig(**SMALL), 13, 8)


def test_cpu_launches_no_kernel(carried):
    jcfg, cfg, _, _, tp, tq = carried
    _, xt, mask = _inputs(10)
    _, trc = _rope(jcfg, mask)
    counts = (L.mlp_int8_launches.n, L.attn_int8_launches.n)
    lq = L.kernel_layout(tq)[0]
    y = L.fused_attn_int8_layer(xt, tp["layers"][0], lq, torch.from_numpy(mask), trc, cfg)
    L.fused_mlp_int8_layer(y, tp["layers"][0]["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
    assert (L.mlp_int8_launches.n, L.attn_int8_launches.n) == counts


def test_kernel_layout_adds_the_transpose(carried):
    *_, tq = carried
    kl = L.kernel_layout(tq)
    for name in M._QUANT_KEYS:
        w = kl[1][name]
        assert w["t"].is_contiguous() and torch.equal(w["t"], tq[1][name]["q"].t())
        assert w["q"] is tq[1][name]["q"] and w["s"] is tq[1][name]["s"]


def test_wrappers_refuse_other_devices(carried):
    """A tensor on neither the CPU nor the card raises: no silent fallback."""
    jcfg, cfg, _, _, tp, tq = carried
    x = torch.empty((70, 256), dtype=torch.bfloat16, device="meta")
    lq = tq[0]
    with pytest.raises(ValueError, match="device"):
        L.fused_mlp_int8_layer(x, tp["layers"][0]["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
    with pytest.raises(ValueError, match="device"):
        L.fused_attn_int8_layer(x.view(7, 10, 256), tp["layers"][0], lq, None, None, cfg)
