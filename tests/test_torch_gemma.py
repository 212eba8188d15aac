"""Port parity: the gemma tower (encoder/gemma.py) and kernel B2's gemma
form (head_dim 256, bidirectional) against the JAX package, with JAX
weights carried over (params_from_jax) and inputs from numpy seeds; the
reference's Pallas kernels run in interpret mode. Also against
transformers' Gemma3TextModel built from a config in code.

GemmaEncoderConfig.tiny() has head_dim 32, which never reaches the
kernel, so the kernel path runs on SMALL: 2 layers, d 256, I 384, 2/1
heads of 256, a global layer every 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.encoder import gemma as JG
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.kernels.attention import fused_qknorm_rope_attention as j_attention
from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
from theoremsearch_tpu_torch.encoder import gemma as G
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.kernels.attention import (
    attention_gemma_launches,
    attention_launches,
    fused_qknorm_rope_attention,
)

torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=256, global_every=2, max_seq_len=64, head_hidden=256,
             embedding_dim=256, query_pre_attn_scalar=256.0)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _batch(b, s, vocab, seed, full=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = np.full(b, s) if full else rng.integers(4, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _carry(jcfg, seed=0, norms=0.1):
    """JAX params with the zero-init (1 + w) norm weights moved off zero
    (so the tests see the weights), and the port's copy of them."""
    jp = JG.init_params(jcfg, jax.random.PRNGKey(seed))
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 100), 1000))
    jp = jax.tree.map(lambda a: a + norms * jax.random.normal(next(keys), a.shape, a.dtype)
                      if a.ndim == 1 else a, jp)
    return jp, G.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = JGemmaConfig(**SMALL), GemmaEncoderConfig(**SMALL)
    jp, tp = _carry(jcfg, seed=1)
    return jcfg, cfg, jp, tp


# ---------------------------------------------------------------- B2, gemma form


@pytest.mark.parametrize("b,s", [(8, 32), (4, 64), (2, 128)])
def test_b2_gemma_plain_matches_jax_interpret(b, s):
    """The port's plain B2 at head_dim 256, causal=False, 3/1 heads, vs
    the reference kernel in interpret mode: cosine > 0.9999 and max abs
    <= 2e-2 * max|ref| (bf16 outputs of f32 softmax sums taken in another
    order)."""
    h, hk, dh = 3, 1, 256
    rng = np.random.default_rng(s)
    q = (2 * rng.standard_normal((b, s, h * dh))).astype(np.float32)
    k = (2 * rng.standard_normal((b, s, hk * dh))).astype(np.float32)
    v = rng.standard_normal((b, s, hk * dh)).astype(np.float32)
    qw, kw = (1.0 + 0.1 * rng.standard_normal((2, dh))).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    ang = pos[..., None] * (1.0 / 10_000 ** (np.arange(0, dh, 2) / dh))[None, None]
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    kw_ = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=False, scale=256 ** -0.5)
    ref = np.asarray(j_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(qw),
                                 jnp.asarray(kw), jnp.asarray(cos), jnp.asarray(sin),
                                 jnp.asarray(mask), interpret=True, **kw_), np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    before = (attention_launches.n, attention_gemma_launches.n)
    out = fused_qknorm_rope_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)), t(qw), t(kw),
                                      t(cos), t(sin), t(mask), **kw_)
    assert (attention_launches.n, attention_gemma_launches.n) == before   # CPU: no launch
    assert out.shape == (b, s, h * dh) and out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert _cos(got.ravel(), ref.ravel()) > 0.9999
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


# ---------------------------------------------------------------- the tower


def test_params_from_jax_keeps_bits_and_the_embed_scale(small):
    """bf16 matrices carry their bits, norms and biases stay f32; at the
    full width d 768 the sqrt(d) embed scale rounds to 27.75 in bf16 as
    the reference keeps it, and one full-width layer agrees with the
    reference's hidden states."""
    jcfg, cfg, jp, tp = small
    w = np.asarray(jp["layers"][1]["wq"])
    np.testing.assert_array_equal(tp["layers"][1]["wq"].view(torch.int16).numpy(), w.view(np.int16))
    assert tp["layers"][0]["post_attn_norm"].dtype == torch.float32
    assert tp["head_b1"].dtype == torch.float32
    assert float(torch.tensor(np.sqrt(768), dtype=torch.bfloat16)) == 27.75
    kw = dict(vocab_size=64, num_layers=1, max_seq_len=16)
    jfull, full = JGemmaConfig(**kw), GemmaEncoderConfig(**kw)
    jpf, tpf = _carry(jfull, seed=11)
    ids, mask = _batch(2, 8, 64, seed=12)
    ref = np.asarray(JG.forward(jpf, jnp.asarray(ids), jnp.asarray(mask), jfull), np.float32)
    got = G.forward(tpf, torch.from_numpy(ids), torch.from_numpy(mask), full, fused="off")
    assert got.dtype == torch.bfloat16
    assert (_cos(got.float().numpy().reshape(16, -1), ref.reshape(16, -1)) > 0.9999).all()


@pytest.mark.parametrize("fused", ["off", "plain", "on"])
def test_tower_matches_jax(small, fused):
    """Pooled embeddings at (8, 32), ragged masks, vs the reference's
    composition ("off") and its fused path in interpret mode: cosine >
    0.9999, the reference's own gate."""
    jcfg, cfg, jp, tp = small
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=2)
    assert G._fused_ok(cfg, 32, 8)
    jfused = "off" if fused == "off" else "interpret"
    ref = np.asarray(JG.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, fused=jfused))
    out = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg, fused=fused)
    assert out.shape == (8, 256) and out.dtype == torch.float32
    assert (_cos(out.numpy(), ref) > 0.9999).all()
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("s", [16, 40])
def test_tiny_sliding_window_binds(s):
    """GemmaEncoderConfig.tiny() (window 16: |d| < 9) at S = 40 > W/2,
    where the sliding layers see only their window, and at S = 16 where
    they do not: cosine > 0.9999 against the reference's composition."""
    jcfg, cfg = JGemmaConfig.tiny(), GemmaEncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=3)
    ids, mask = _batch(4, s, cfg.vocab_size, seed=s, full=True)
    assert not G._fused_ok(cfg, s, 4)
    ref = np.asarray(JG.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    out = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    assert (_cos(out, ref) > 0.9999).all()
    # the window really cuts at S = 40: a far token moves a sliding-only
    # first layer's hidden state of position 0 not at all
    hid = G.forward({**tp, "layers": tp["layers"][:1]}, torch.from_numpy(ids), torch.from_numpy(mask),
                    cfg)
    ids2 = ids.copy()
    ids2[:, -1] = (ids2[:, -1] + 1) % cfg.vocab_size
    hid2 = G.forward({**tp, "layers": tp["layers"][:1]}, torch.from_numpy(ids2), torch.from_numpy(mask),
                     cfg)
    assert torch.equal(hid[:, 0], hid2[:, 0]) == (s > 9)


@pytest.mark.parametrize("theta,factor", [(1e6, 1.0), (1e6, 8.0), (1e4, 1.0)])
def test_rope_tables_match_jax(theta, factor):
    """Global (with linear rope scaling) and local rope tables at head_dim
    256 on ragged positions: within 2e-6 of the reference's (f32 pow and
    cos/sin implementations differ in the last bits)."""
    _, mask = _batch(4, 64, 10, seed=13)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    jc, js = JG._rope_tables(jnp.asarray(pos), 256, theta, factor)
    tc, ts = G._rope_tables(torch.from_numpy(pos), 256, theta, factor)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)


def test_fused_ok_is_the_references():
    for kw in (SMALL, dict(SMALL, sliding_window=32), dict(SMALL, head_dim=128)):
        jcfg, cfg = JGemmaConfig(**kw), GemmaEncoderConfig(**kw)
        for s, b in ((16, 8), (32, 8), (64, 4), (64, 3), (128, 1), (13, 9), (256, 2)):
            assert G._fused_ok(cfg, s, b) == JG._fused_ok(jcfg, s, b), (kw, s, b)
            assert G._fused_layer_ok(cfg, s, b) == JG._fused_layer_ok(jcfg, s, b), (kw, s, b)
    assert G._fused_layer_ok(GemmaEncoderConfig(), 64, 512)
    assert not G._fused_ok(GemmaEncoderConfig(sliding_window=64), 64, 512)   # 63 > 32


@pytest.mark.parametrize("fused_layers", [False, True])
def test_int8_tower_matches_jax(small, fused_layers):
    """int8 (w8a8): the reference's jitted int8 weights carried over, the
    op-chain and the whole-layer route vs the reference in interpret
    mode: cosine > 0.999 end to end (the reference's own int8 gate: its
    jitted and eager chains agree only to ~0.9995 on random weights)."""
    jcfg, cfg, jp, tp = small
    jq = jax.jit(JG.quantize_params_int8)(jp)
    tq = G.params_from_jax(jax.device_get(jq), device="cpu")
    for a, b in zip(G.quantize_params_int8(tp), tq):
        for n in a:
            assert torch.equal(a[n]["q"], b[n]["q"]) and torch.equal(a[n]["s"], b[n]["s"])
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=4)
    ref = np.asarray(JG.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                      fused="interpret", qlayers=jq, fused_layers=fused_layers))
    out = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg, qlayers=tq,
                          fused_layers=fused_layers).numpy()
    assert (_cos(out, ref) > 0.999).all()
    bf = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    assert (_cos(out, bf) > 0.98).all()   # int8 tracks bf16 (the reference's gate)


def test_int8_sliding_op_chain_matches_jax():
    """The int8 op-chain where the window binds (tiny, S = 40)."""
    jcfg, cfg = JGemmaConfig.tiny(), GemmaEncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=5)
    jq = jax.jit(JG.quantize_params_int8)(jp)
    ids, mask = _batch(4, 40, cfg.vocab_size, seed=6)
    ref = np.asarray(JG.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, qlayers=jq))
    out = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                          qlayers=G.quantize_params_int8(tp)).numpy()
    assert (_cos(out, ref) > 0.999).all()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_batched_encoder_matches_jax(quant):
    """BatchedEncoder on the gemma tower (tiny; 21 texts, batch 8: the
    sorted multi-sub-batch route) vs the reference's, with role prompts."""
    jcfg, cfg = JGemmaConfig.tiny(), GemmaEncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=7)
    texts = [f"theorem {i}: every {'compact ' * (i % 5)}space is {'nice ' * i}" for i in range(21)]
    prompts = {"query": "task: search result | query: "}
    ref = JBatchedEncoder(jp, jcfg, batch_size=8, prompts=prompts, quant=quant).encode(
        texts, role="query")
    enc = BatchedEncoder(tp, cfg, batch_size=8, prompts=prompts, quant=quant)
    out = enc.encode(texts, role="query")
    assert out.shape == ref.shape == (21, cfg.embedding_dim)
    assert (_cos(out, ref) > (0.999 if quant == "int8" else 0.9999)).all()
    dev = enc.encode_device(texts, role="query")
    np.testing.assert_allclose(dev[:21].numpy(), out, atol=1e-6)


def test_batched_encoder_small_runs_the_fused_route_without_launches(small):
    """On the head_dim-256 config the serving buckets pass `_fused_ok`;
    on the CPU they take the plain versions (no launch)."""
    _, cfg, _, tp = small
    texts = [f"every {'compact ' * (i % 3)}space {i} is normal" for i in range(6)]
    counts = (attention_launches.n, attention_gemma_launches.n)
    for quant in ("none", "int8"):
        out = BatchedEncoder(tp, cfg, batch_size=8, quant=quant).encode(texts)
        assert out.shape == (6, 256) and np.isfinite(out).all()
    assert (attention_launches.n, attention_gemma_launches.n) == counts


# ---------------------------------------------------------------- gradients


def test_fused_core_gradient_matches_jax_custom_vjp(small):
    """GemmaAttentionCore's backward (autograd through the reference
    composition) vs jax.grad through the reference's custom VJP, on q, k,
    v and the (1 + w) weights: cosine >= 0.999; and a gradient reaches
    wq through the fused path of the tower."""
    jcfg, cfg, jp, tp = small
    b, s, h, hk, dh = 4, 32, 2, 1, 256
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((b, s, n * dh)).astype(np.float32) for n in (h, hk, hk))
    qw, kw = (1.0 + 0.1 * rng.standard_normal((2, dh))).astype(np.float32)
    _, mask = _batch(b, s, 10, seed=9)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    cos, sin = (np.array(t) for t in JG._rope_tables(jnp.asarray(pos), dh, 10_000.0))
    g = rng.standard_normal((b, s, h * dh)).astype(np.float32)
    scale = 256 ** -0.5
    core = JG._make_attn_core(h, hk, dh, 1e-6, scale, True)

    def jloss(q_, k_, v_, qw_, kw_):
        out = core(q_, k_, v_, qw_, kw_, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * g)

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(bf(q), bf(k), bf(v), jnp.asarray(qw),
                                                     jnp.asarray(kw))
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    ins += [torch.from_numpy(a).requires_grad_(True) for a in (qw, kw)]
    out = G.GemmaAttentionCore.apply(*ins, torch.from_numpy(cos), torch.from_numpy(sin),
                                     torch.from_numpy(mask), h, hk, dh, 1e-6, scale, True)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), ins)
    for a, r in zip(grads, jgrads):
        assert a.dtype == (torch.bfloat16 if a.ndim == 3 else torch.float32)
        assert _cos(a.float().numpy().ravel(), np.asarray(r, np.float32).ravel()) >= 0.999

    ids, mk = _batch(8, 32, cfg.vocab_size, seed=10)
    wq = tp["layers"][0]["wq"].requires_grad_(True)
    try:
        pooled = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mk), cfg, fused="on")
        (gwq,) = torch.autograd.grad(pooled.sum(), [wq])
    finally:
        wq.requires_grad_(False)
    assert float(gwq.float().abs().max()) > 0


# ---------------------------------------------------------------- transformers


def _hf_gemma(cfg):
    transformers = pytest.importorskip("transformers")
    layer_types = ["full_attention" if G.is_global_layer(cfg, i) else "sliding_attention"
                   for i in range(cfg.num_layers)]
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        rope_local_base_freq=cfg.rope_local_theta, rope_scaling=None,
        sliding_window=cfg.sliding_window, layer_types=layer_types,
        query_pre_attn_scalar=cfg.query_pre_attn_scalar, rms_norm_eps=cfg.rms_norm_eps,
        max_position_embeddings=cfg.max_seq_len, use_bidirectional_attention=True,
        attention_dropout=0.0, attn_implementation="eager")
    m = transformers.Gemma3TextModel(hf_cfg).to(torch.float32).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return m


def _params_from_hf(m, cfg):
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    names = {"attn_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "pre_mlp_norm": "pre_feedforward_layernorm",
             "post_mlp_norm": "post_feedforward_layernorm", "q_norm": "self_attn.q_norm",
             "k_norm": "self_attn.k_norm", "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj",
             "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    layers = []
    for i in range(cfg.num_layers):
        layer = {}
        for ours, theirs in names.items():
            w = sd[f"layers.{i}.{theirs}.weight"]
            layer[ours] = w.T.contiguous() if w.ndim == 2 else w
        layers.append(layer)
    return {"embed": sd["embed_tokens.weight"], "final_norm": sd["norm.weight"], "layers": layers}


@pytest.mark.parametrize("s,padded", [(48, False), (40, True)])
def test_hidden_states_match_transformers(s, padded):
    """f32 tiny tower (S > window: both rope kinds and the window) vs
    Gemma3TextModel(use_bidirectional_attention=True): real-token hidden
    states within 2e-4, the reference's own tolerance."""
    cfg = GemmaEncoderConfig(**{**GemmaEncoderConfig.tiny().__dict__, "dtype": "float32",
                                "param_dtype": "float32"})
    m = _hf_gemma(cfg)
    params = _params_from_hf(m, cfg)
    rng = np.random.default_rng(s)
    ids = rng.integers(0, cfg.vocab_size, (3, s)).astype(np.int64)
    lens = [s, 22, 9] if padded else [s] * 3
    mask = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int64)
    with torch.no_grad():
        ref = m(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
    got = G.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg, fused="off")
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(), ref[i, :n].numpy(), rtol=2e-4, atol=2e-4)
