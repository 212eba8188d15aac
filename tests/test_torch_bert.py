"""Port parity: the BERT tower (encoder/bert.py; at head_dim 64 its
attention core on BERT's kernel, the plain version on the CPU) against the
JAX package with JAX weights carried over, against transformers'
BertModel built from a config in code, and through BatchedEncoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
from theoremsearch_tpu.encoder import bert as JB
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu_torch.core.config import BertEncoderConfig
from theoremsearch_tpu_torch.encoder import bert as PB
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

torch.set_num_threads(1)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _batch(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(4, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _carry(jcfg, seed):
    """JAX params with biases and LayerNorm parameters moved off their
    init values (so the tests see them), and the port's copy."""
    jp = JB.init_params(jcfg, jax.random.PRNGKey(seed))
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 100), 1000))
    jp = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape, a.dtype)
                      if a.ndim == 1 else a, jp)
    return jp, PB.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_tower_matches_jax(act):
    """Pooled embeddings of the tiny tower, bf16, ragged masks, exact and
    tanh GELU: cosine > 0.9999 against the reference."""
    jcfg = JBertConfig(**{**JBertConfig.tiny().__dict__, "hidden_act": act})
    cfg = BertEncoderConfig(**{**BertEncoderConfig.tiny().__dict__, "hidden_act": act})
    jp, tp = _carry(jcfg, seed=1)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=2)
    ref = np.asarray(JB.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    out = PB.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg, fused="on")
    assert out.shape == (8, cfg.embedding_dim) and out.dtype == torch.float32
    assert (_cos(out.numpy(), ref) > 0.9999).all()
    hid = PB.forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    jhid = np.asarray(JB.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg), np.float32)
    assert hid.dtype == torch.bfloat16
    assert (_cos(hid.float().numpy()[mask > 0], jhid[mask > 0]) > 0.9999).all()


# BERT-base's head width (64), so the default route takes BERT's attention
# kernel: its plain version for CPU tensors
HEAD64 = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
              max_seq_len=512, embedding_dim=128)


@pytest.mark.parametrize("s", [64, 256])
def test_kernel_route_matches_jax(s, monkeypatch):
    """The tower at head_dim 64 under inference, fused="on" (the attention
    core on the kernel's plain version) against the reference's
    composition on the same ids and mask: pooled cosine > 0.9999, hidden
    states at the real rows > 0.9999; the composition never runs."""
    import theoremsearch_tpu_torch.kernels.attention_bert as KB

    ran = []

    def plain(*a, **kw):
        ran.append("plain")
        return KB_plain(*a, **kw)

    def composition(*a, **kw):
        ran.append("composition")
        return PB_core(*a, **kw)

    KB_plain, PB_core = KB.bert_attention_plain, PB._attention_core
    monkeypatch.setattr(KB, "bert_attention_plain", plain)
    monkeypatch.setattr(PB, "_attention_core", composition)
    jcfg = JBertConfig(**{**JBertConfig.tiny().__dict__, **HEAD64})
    cfg = BertEncoderConfig(**{**BertEncoderConfig.tiny().__dict__, **HEAD64})
    jp, tp = _carry(jcfg, seed=4)
    ids, mask = _batch(6, s, cfg.vocab_size, seed=5)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        out = PB.encode_pooled(tp, tids, tmask, cfg, fused="on")
        hid = PB.forward(tp, tids, tmask, cfg)
    assert ran == ["plain"] * (2 * cfg.num_layers)
    ref = np.asarray(JB.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    assert (_cos(out.numpy(), ref) > 0.9999).all()
    jhid = np.asarray(JB.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg), np.float32)
    assert (_cos(hid.float().numpy()[mask > 0], jhid[mask > 0]) > 0.9999).all()


def test_init_params_has_the_references_tree():
    jp = JB.init_params(JBertConfig.tiny(), jax.random.PRNGKey(0))
    tp = PB.init_params(BertEncoderConfig.tiny(), torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(len(layer) for layer in tp["layers"]) + len(tp) - 1
    for path, a in flat_j:
        t = tp
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[1] == str(a.dtype), path


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_batched_encoder(quant):
    """BatchedEncoder on the BERT tower (21 texts, batch 8) vs the
    reference's; quant="int8" raises ValueError in both, as the tower
    has no int8 form."""
    jcfg, cfg = JBertConfig.tiny(), BertEncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=3)
    if quant == "int8":
        with pytest.raises(ValueError, match="int8"):
            JBatchedEncoder(jp, jcfg, quant="int8")
        with pytest.raises(ValueError, match="int8"):
            BatchedEncoder(tp, cfg, quant="int8")
        return
    texts = [f"lemma {i}: each {'finite ' * (i % 4)}group is {'solvable ' * i}" for i in range(21)]
    ref = JBatchedEncoder(jp, jcfg, batch_size=8).encode(texts)
    out = BatchedEncoder(tp, cfg, batch_size=8).encode(texts)
    assert out.shape == ref.shape == (21, cfg.embedding_dim)
    assert (_cos(out, ref) > 0.9999).all()


def _hf_bert(cfg):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        hidden_act=cfg.hidden_act, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=cfg.max_seq_len, type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps, attn_implementation="eager")
    m = transformers.BertModel(hf_cfg).to(torch.float32).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return m


_HF_LAYER = {"wq": "attention.self.query", "wk": "attention.self.key", "wv": "attention.self.value",
             "wo": "attention.output.dense", "w_in": "intermediate.dense", "w_out": "output.dense"}
_HF_BIAS = {"bq": "attention.self.query", "bk": "attention.self.key", "bv": "attention.self.value",
            "bo": "attention.output.dense", "b_in": "intermediate.dense", "b_out": "output.dense"}
_HF_LN = {"attn_ln": "attention.output.LayerNorm", "mlp_ln": "output.LayerNorm"}


def _params_from_hf(m, cfg):
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layer = {k: sd[p + v + ".weight"].T.contiguous() for k, v in _HF_LAYER.items()}
        layer |= {k: sd[p + v + ".bias"] for k, v in _HF_BIAS.items()}
        for k, v in _HF_LN.items():
            layer[k + "_g"], layer[k + "_b"] = sd[p + v + ".weight"], sd[p + v + ".bias"]
        layers.append(layer)
    return {"embed": sd["embeddings.word_embeddings.weight"],
            "pos_embed": sd["embeddings.position_embeddings.weight"],
            "type_embed": sd["embeddings.token_type_embeddings.weight"],
            "embed_ln_g": sd["embeddings.LayerNorm.weight"],
            "embed_ln_b": sd["embeddings.LayerNorm.bias"], "layers": layers}


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_hidden_states_match_transformers(act):
    """f32 tiny tower vs BertModel on right-padded batches: real-token
    hidden states within 2e-4 (the reference's own tolerance)."""
    cfg = BertEncoderConfig(**{**BertEncoderConfig.tiny().__dict__, "dtype": "float32",
                               "param_dtype": "float32", "hidden_act": act})
    m = _hf_bert(cfg)
    params = _params_from_hf(m, cfg)
    rng = np.random.default_rng(5)
    s, lens = 24, [24, 13, 5]
    ids = rng.integers(0, cfg.vocab_size, (3, s)).astype(np.int64)
    mask = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int64)
    with torch.no_grad():
        ref = m(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
    got = PB.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(), ref[i, :n].numpy(), rtol=2e-4, atol=2e-4)
