"""Port parity: the Qwen3-class encoder (pooled embeddings) and the
batching layer, JAX weights carried over with params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.encoder.model import encode_pooled as j_encode_pooled
from theoremsearch_tpu.encoder.model import init_params as j_init_params
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import _fused_ok, encode_pooled, params_from_jax
from theoremsearch_tpu_torch.kernels.attention import attention_launches

torch.set_num_threads(1)

# head_dim 128 reaches the fused attention path (EncoderConfig.tiny() has
# head_dim 32, which the reference never sends to its kernel)
SMALL = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)


def _batch(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(4, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _carry(jcfg, seed=0):
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def test_params_from_jax_keeps_bf16_bits():
    jp, tp = _carry(JEncoderConfig.tiny())
    w = np.asarray(jp["layers"][1]["wq"])
    assert tp["layers"][1]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"][1]["wq"].view(torch.int16).numpy(), w.view(np.int16))
    assert tp["layers"][0]["q_norm"].dtype == torch.float32


def test_fused_path_matches_jax_interpret_kernel():
    jcfg, cfg = JEncoderConfig(**SMALL), EncoderConfig(**SMALL)
    jp, tp = _carry(jcfg, seed=1)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=2)
    assert _fused_ok(cfg, 32, 8)
    ref = np.asarray(j_encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, fused="interpret"))
    out = encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    assert out.shape == (8, 256) and out.dtype == torch.float32
    c = _cos(out.numpy(), ref)
    assert (c > 0.9999).all(), c


def test_tiny_matches_jax_reference_composition():
    jcfg, cfg = JEncoderConfig.tiny(), EncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=3)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=4)
    ref = np.asarray(j_encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, fused="off"))
    out = encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    c = _cos(out, ref)
    assert (c > 0.9999).all(), c
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("n", [5, 21])
def test_batched_encoder_matches_jax(n):
    """Same buckets, prompts and order as the reference's BatchedEncoder;
    n=21 with batch_size 8 takes the multi-sub-batch (sorted) route."""
    jcfg, cfg = JEncoderConfig.tiny(), EncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=5)
    texts = [f"theorem {i}: every {'compact ' * (i % 5)}space is {'nice ' * i}" for i in range(n)]
    prompts = {"query": "find: "}
    ref = JBatchedEncoder(jp, jcfg, batch_size=8, prompts=prompts).encode(texts, role="query")
    enc = BatchedEncoder(tp, cfg, batch_size=8, prompts=prompts)
    out = enc.for_role("query")(texts)
    assert out.shape == ref.shape == (n, cfg.embedding_dim)
    assert (_cos(out, ref) > 0.9999).all()
    dev = enc.encode_device(texts, role="query")
    assert dev.shape == (32 if n > 16 else 8, cfg.embedding_dim)
    np.testing.assert_allclose(dev[:n].numpy(), out, atol=1e-6)


def test_unported_modes_raise():
    cfg = EncoderConfig.tiny()
    _, tp = _carry(JEncoderConfig.tiny())
    with pytest.raises(NotImplementedError):
        BatchedEncoder(tp, cfg, quant="int8")
    with pytest.raises(NotImplementedError):
        BatchedEncoder(tp, cfg, mesh=object())


def test_cpu_forward_launches_no_kernel():
    cfg = EncoderConfig(**SMALL)
    _, tp = _carry(JEncoderConfig(**SMALL))
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=6)
    before = attention_launches.n
    encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    assert attention_launches.n == before
