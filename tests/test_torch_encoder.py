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
from theoremsearch_tpu.encoder.model import quantize_params_int8 as j_quantize_params_int8
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder import model as M
from theoremsearch_tpu_torch.encoder.model import (
    _fused_ok,
    encode_pooled,
    params_from_jax,
    quantize_params_int8,
)
from theoremsearch_tpu_torch.kernels.attention import attention_launches
from theoremsearch_tpu_torch.kernels.layer_int8 import attn_int8_launches, mlp_int8_launches

from torch_helpers import cpu_mesh

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
    """An unknown quant mode is refused, and so is int8 on a tensor-parallel
    mesh (shard > 1; "dp-only", as the reference). A tp mesh encodes, with
    full params (data parallel: the shard axis computes nothing new) and
    with sharded ones (tests/test_torch_tp_encode.py)."""
    cfg = EncoderConfig.tiny()
    _, tp = _carry(JEncoderConfig.tiny())
    with pytest.raises(ValueError, match="quant"):
        BatchedEncoder(tp, cfg, quant="int4")
    with pytest.raises(ValueError, match="dp-only"):
        BatchedEncoder(tp, cfg, mesh=cpu_mesh(2), quant="int8")
    texts = ["a theorem on primes", "a lemma"]
    one = BatchedEncoder(tp, cfg, device="cpu").encode(texts)
    for params in (tp, M.shard_params(tp, cpu_mesh(2))):
        out = BatchedEncoder(params, cfg, mesh=cpu_mesh(2)).encode(texts)
        assert (_cos(out, one) > 0.9999).all()


def test_cpu_forward_launches_no_kernel():
    cfg = EncoderConfig(**SMALL)
    _, tp = _carry(JEncoderConfig(**SMALL))
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=6)
    before = attention_launches.n
    encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    assert attention_launches.n == before


# int8 (w8a8) serving mode, on the reference's int8 test shapes
# (tests/test_encoder.py: hidden 256, intermediate 512, 4/2 heads of 128)
SMALL8 = dict(SMALL, num_heads=4, num_kv_heads=2)


def _int8_pair(seed):
    """Both packages' params, and the reference's jitted int8 weights
    carried over as they are (forward accepts them directly)."""
    jcfg, cfg = JEncoderConfig(**SMALL8), EncoderConfig(**SMALL8)
    jp, tp = _carry(jcfg, seed=seed)
    jq = jax.jit(j_quantize_params_int8)(jp)
    return jcfg, cfg, jp, tp, jq, params_from_jax(jax.device_get(jq), device="cpu")


@pytest.mark.parametrize("fused_layers", [False, True])
def test_int8_forward_matches_jax_interpret(fused_layers):
    """The int8 op-chain (kernel B2's plain core) and the whole-layer
    route (B3/B4's plain versions) vs the reference in Pallas interpret
    mode, end to end: cosine > 0.999, the reference's own end-to-end gate
    (tests/test_encoder.py:434). Not 0.9999: a one-code flip in a per-token
    quant moves the whole row, and two layers of these random weights
    amplify it, so the reference's jitted and eager int8 chains agree
    only to ~0.9995 on them. Block by block, on the same input, the port
    holds 0.9999 (tests/test_torch_layer_int8.py)."""
    gate = 0.999
    jcfg, cfg, jp, tp, jq, tq = _int8_pair(seed=7)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=8)
    ref = np.asarray(j_encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                     fused="interpret", qlayers=jq, fused_layers=fused_layers))
    out = encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg, qlayers=tq,
                        fused_layers=fused_layers).numpy()
    c = _cos(out, ref)
    assert (c > gate).all(), c


def test_int8_tracks_bf16():
    """int8 vs the bf16 forward on the same weights: > 0.98, the
    reference's gate for the quantized mode (tests/test_encoder.py:333)."""
    _, cfg, _, tp, _, _ = _int8_pair(seed=9)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=10)
    a = encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    b = encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                      qlayers=quantize_params_int8(tp), fused_layers=True).numpy()
    c = _cos(a, b)
    assert (c > 0.98).all(), c


def test_batched_encoder_int8_matches_jax():
    """BatchedEncoder(quant="int8") vs the reference's on the tiny config
    (head_dim 32: both run the int8 op-chain with the plain attention)."""
    jcfg, cfg = JEncoderConfig.tiny(), EncoderConfig.tiny()
    jp, tp = _carry(jcfg, seed=11)
    texts = [f"lemma {i}: each {'finite ' * (i % 4)}group is {'solvable ' * i}" for i in range(11)]
    ref = JBatchedEncoder(jp, jcfg, batch_size=8, quant="int8").encode(texts)
    enc = BatchedEncoder(tp, cfg, batch_size=8, quant="int8")
    assert enc.qlayers is not None and "t" not in enc.qlayers[0]["wq"]   # CPU: no kernel layout
    out = enc.encode(texts)
    c = _cos(out, ref)
    assert out.shape == ref.shape and (c > 0.999).all(), c


def test_batched_encoder_int8_whole_layers_on_cpu():
    """On the head_dim-128 config the int8 encoder takes the whole-layer
    route for qualifying buckets, through the plain versions on the CPU
    (no launch), and agrees with the op-chain."""
    _, cfg, _, tp, _, _ = _int8_pair(seed=12)
    texts = [f"every {'compact ' * (i % 3)}space {i} is normal" for i in range(6)]
    enc = BatchedEncoder(tp, cfg, batch_size=8, quant="int8")
    counts = (attn_int8_launches.n, mlp_int8_launches.n, attention_launches.n)
    out = enc.encode(texts)
    assert (attn_int8_launches.n, mlp_int8_launches.n, attention_launches.n) == counts
    ids_mask, _ = enc._prep_batch(texts, [enc.tokenizer.tokenize(t) for t in texts], range(6))
    assert M._fused_layer_ok(cfg, ids_mask.shape[2], ids_mask.shape[1])
    chain = encode_pooled(tp, torch.from_numpy(ids_mask[0]), torch.from_numpy(ids_mask[1]), cfg,
                          qlayers=enc.qlayers)[:6].numpy()
    assert (_cos(out, chain) > 0.999).all()
