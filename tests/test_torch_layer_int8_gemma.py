"""Port parity: the gemma forms of the whole-layer int8 blocks, B3
(`fused_attn_int8_layer_gemma`) and B4 (`fused_mlp_int8_layer(act=
"gelu_tanh", post_w=)`), through their plain versions on the CPU, against
the reference kernels in Pallas interpret mode, on a small head_dim-256
gemma config with its (1 + w) norm weights off zero."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.encoder import gemma as JG
from theoremsearch_tpu.kernels import layer_int8 as JL
from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
from theoremsearch_tpu_torch.encoder import gemma as G
from theoremsearch_tpu_torch.kernels import layer_int8 as L

torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=256, global_every=2, max_seq_len=64, head_hidden=256,
             embedding_dim=256, query_pre_attn_scalar=256.0)
B, S, D = 8, 32, 256


def _cos(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def carried():
    """JAX params (norm weights moved off zero) with their jitted int8
    weights, and both carried over."""
    jcfg, cfg = JGemmaConfig(**SMALL), GemmaEncoderConfig(**SMALL)
    jp = JG.init_params(jcfg, jax.random.PRNGKey(3))
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 1000))
    jp = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape, a.dtype)
                      if a.ndim == 1 else a, jp)
    jq = jax.jit(JG.quantize_params_int8)(jp)
    tp = G.params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, cfg, jp, jq, tp, G.quantize_params_int8(tp)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    lens = rng.integers(4, S, B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16), mask


def _rope(jcfg, mask, glob):
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    theta = jcfg.rope_theta if glob else jcfg.rope_local_theta
    jrc = JG._rope_tables(jnp.asarray(pos), jcfg.head_dim, theta)
    return jrc, tuple(torch.from_numpy(np.array(t)) for t in jrc)


def test_int8_weight_codes_bit_equal_to_jitted_jax(carried):
    *_, jq, _, tq = carried
    for jl, tl in zip(jq, tq):
        for k in tl:
            np.testing.assert_array_equal(tl[k]["q"].numpy(), np.asarray(jl[k]["q"]))
            np.testing.assert_array_equal(tl[k]["s"].numpy(), np.asarray(jl[k]["s"]))


def test_gelu_tanh_is_the_references():
    """The port's tanh GELU vs jax.nn.gelu(approximate=True) in f32: the
    two tanh implementations round differently in the last bit, which
    1 + tanh carries as an error of up to ~ulp(1) = 1.2e-7 (large relative
    to the result in the negative tail), times 0.5 |x|; so |got - ref| <=
    4.8e-7 |ref| + 2.4e-7 |x|."""
    x = (3 * np.random.default_rng(0).standard_normal(20_000)).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = L.gelu_tanh(torch.from_numpy(x)).numpy()
    assert (np.abs(got - ref) <= 4.8e-7 * np.abs(ref) + 2.4e-7 * np.abs(x)).all()


def test_post_norm_matches_jax(carried):
    """The post-norm plain version vs the reference kernel's `_post_norm`
    on bf16 block outputs, both rounded to bf16: at most one bf16 ulp
    apart (the port sums the squares in f64, the reference in f32)."""
    rng = np.random.default_rng(1)
    y = (5 * rng.standard_normal((64, D))).astype(np.float32)
    pw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = np.asarray(jax.jit(JL._post_norm, static_argnums=2)(jnp.asarray(y), jnp.asarray(pw)[None],
                                                             1e-6).astype(jnp.bfloat16), np.float32)
    got = L.post_norm_plain(torch.from_numpy(y), torch.from_numpy(pw), 1e-6).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("rows", ["b8s32", "t70"])
def test_mlp_gemma_form_matches_jax_interpret(carried, rows):
    """B4's gemma form (GeGLU, (1 + w) pre- and post-norm) vs the reference
    kernel in interpret mode, at B*S = 256 and T = 70 (the reference's
    zero-pad branch): cosine > 0.9999 on the output and on the block's own
    contribution (out - x)."""
    jcfg, _, jp, jq, tp, tq = carried
    xj, xt, _ = _inputs(5)
    if rows == "t70":
        xj, xt = xj[:3].reshape(-1, D)[:70], xt[:3].reshape(-1, D)[:70]
    jl, tl, jlay, tlay = jq[0], tq[0], jp["layers"][0], tp["layers"][0]
    one = jnp.float32(1.0)
    ref = JL.fused_mlp_int8_layer(xj, one + jlay["pre_mlp_norm"], jl["w_gate"], jl["w_up"],
                                  jl["w_down"], post_w=one + jlay["post_mlp_norm"],
                                  eps=jcfg.rms_norm_eps, act="gelu_tanh", interpret=True)
    counts = (L.mlp_int8_launches.n, L.mlp_int8_gemma_launches.n)
    out = L.fused_mlp_int8_layer(xt, 1.0 + tlay["pre_mlp_norm"], tl["w_gate"], tl["w_up"],
                                 tl["w_down"], 1.0 + tlay["post_mlp_norm"], eps=jcfg.rms_norm_eps,
                                 act="gelu_tanh")
    assert (L.mlp_int8_launches.n, L.mlp_int8_gemma_launches.n) == counts   # CPU: no launch
    assert out.shape == xt.shape and out.dtype == torch.bfloat16
    assert _cos(ref, _f32(out)) > 0.9999
    assert _cos(_f32(ref) - _f32(xj), _f32(out) - _f32(xt)) > 0.9999


@pytest.mark.parametrize("layer", [0, 1])
def test_attn_gemma_form_matches_jax_interpret(carried, layer):
    """B3's gemma form (bidirectional head_dim-256 core, post-norm) vs the
    reference kernel in interpret mode, a sliding layer (0) and a global
    one (1) with their own rope tables: cosine > 0.9999 on the output and
    on the block's contribution."""
    jcfg, cfg, jp, jq, tp, tq = carried
    xj, xt, mask = _inputs(6 + layer)
    jrc, trc = _rope(jcfg, mask, glob=JG.is_global_layer(jcfg, layer))
    ref = JL.fused_attn_int8_layer_gemma(xj, jp["layers"][layer], jq[layer], jnp.asarray(mask), jrc,
                                         jcfg, interpret=True)
    out = L.fused_attn_int8_layer_gemma(xt, tp["layers"][layer], tq[layer], torch.from_numpy(mask),
                                        trc, cfg)
    assert out.shape == (B, S, D) and out.dtype == torch.bfloat16
    assert _cos(ref, _f32(out)) > 0.9999
    assert _cos(_f32(ref) - _f32(xj), _f32(out) - _f32(xt)) > 0.9999


def test_op_chain_blocks_match_jax(carried):
    """The gemma int8 op-chain's blocks vs the reference's jitted chain,
    block by block on the same input: cosine > 0.9999."""
    jcfg, cfg, jp, jq, tp, tq = carried
    xj, xt, mask = _inputs(8)
    jrc, trc = _rope(jcfg, mask, glob=True)
    valid = np.broadcast_to(mask.astype(bool)[:, None, None, :], (B, 1, S, S))
    jattn = jax.jit(functools.partial(JG._attention_int8, cfg=jcfg, use_fused=True, interpret=True))
    ref = jattn(jp["layers"][0], jq[0], xj, jnp.asarray(mask), jnp.asarray(valid), jrc)
    out = G._attention_int8(tp["layers"][0], tq[0], xt, torch.from_numpy(mask),
                            torch.from_numpy(valid.copy()), trc, cfg, True, plain=False)
    assert _cos(ref, _f32(out)) > 0.9999
    ref = jax.jit(JG._mlp_int8, static_argnums=3)(jp["layers"][1], jq[1], xj, jcfg.rms_norm_eps)
    out = G._mlp_int8(tp["layers"][1], tq[1], xt, cfg.rms_norm_eps)
    assert _cos(ref, _f32(out)) > 0.9999


def test_plain_whole_layers_track_the_op_chain(carried):
    """The whole-layer plain versions are the op-chain's arithmetic with
    the residual add and the post-norm folded in; the post-norm's f64 sum
    of squares may move a bf16 output by one ulp: cosine > 0.99999."""
    jcfg, cfg, _, _, tp, tq = carried
    _, xt, mask = _inputs(9)
    _, trc = _rope(jcfg, mask, glob=False)
    layer, lq = tp["layers"][0], tq[0]
    m = torch.from_numpy(mask)
    a = L.fused_attn_int8_layer_gemma_plain(xt, layer, lq, m, trc, cfg)
    valid = m.bool()[:, None, None, :].expand(B, 1, S, S)
    chain = xt + G._gemma_rms_norm(G._attention_int8(layer, lq, xt, m, valid, trc, cfg, True, True),
                                   layer["post_attn_norm"], cfg.rms_norm_eps)
    assert _cos(_f32(a), _f32(chain)) > 0.99999
    b = L.fused_mlp_int8_layer_plain(a, 1.0 + layer["pre_mlp_norm"], lq["w_gate"], lq["w_up"],
                                     lq["w_down"], 1.0 + layer["post_mlp_norm"],
                                     eps=cfg.rms_norm_eps, act="gelu_tanh")
    chain = a + G._gemma_rms_norm(G._mlp_int8(layer, lq, a, cfg.rms_norm_eps),
                                  layer["post_mlp_norm"], cfg.rms_norm_eps)
    assert _cos(_f32(b), _f32(chain)) > 0.99999


def test_gemma_forms_refuse_what_they_do_not_take(carried):
    """An unknown activation, a tensor on neither the CPU nor the card,
    and an input that requires grad (the int8 kernels have no backward)
    all raise."""
    jcfg, cfg, _, _, tp, tq = carried
    lq, layer = tq[0], tp["layers"][0]
    x = torch.zeros((70, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="activation"):
        L.fused_mlp_int8_layer(x, layer["pre_mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"],
                               act="relu")
    meta = torch.empty((7, 10, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        L.fused_mlp_int8_layer(meta.view(70, D), layer["pre_mlp_norm"], lq["w_gate"], lq["w_up"],
                               lq["w_down"], layer["post_mlp_norm"], act="gelu_tanh")
    with pytest.raises(ValueError, match="device"):
        L.fused_attn_int8_layer_gemma(meta, layer, lq, None, None, cfg)
    w = layer["post_mlp_norm"].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="inference-only"):
        L.fused_mlp_int8_layer(x, layer["pre_mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"], w,
                               act="gelu_tanh")
