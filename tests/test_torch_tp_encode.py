"""Port parity: tensor-parallel encoding (`shard_params` + the towers' tp
forwards, `BatchedEncoder` on a mesh with shard > 1) against the JAX
package's sharded forward on its 8-device CPU mesh, and against the
port's own single-device path: twins of tests/test_encoder.py:157-168,
tests/test_gemma_loader.py:170-186 and tests/test_bert_parity.py:200-216.

Both attention layouts run: head-local (the kv heads divide over the
shards: each shard's core on its own heads; qwen and gemma at head_dim
128 / 256 reach the fused core, kernel B2's plain version here) and
gathered (qwen tiny on 4 shards, gemma's one kv head, BERT tiny on 8).
The JAX side runs its mesh default, fused "off" (its Pallas kernels are
opaque to GSPMD). The port's meshes repeat "cpu"."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.encoder import bert as j_bert
from theoremsearch_tpu.encoder import gemma as j_gemma
from theoremsearch_tpu.encoder import model as j_model
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu_torch.core.config import BertEncoderConfig, EncoderConfig, GemmaEncoderConfig
from theoremsearch_tpu_torch.encoder import bert, gemma, model
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import params_from_jax

from torch_helpers import cpu_mesh

torch.set_num_threads(2)

QWEN = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=128, max_seq_len=64, embedding_dim=256)
GEMMA = dict(vocab_size=1024, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=256, global_every=2, max_seq_len=64, head_hidden=256,
             embedding_dim=256, query_pre_attn_scalar=256.0)

# name: (JAX module, port module, JAX config, port config, shard, data, head-local)
CASES = {
    "qwen_local": (j_model, model, JEncoderConfig(**QWEN), EncoderConfig(**QWEN), 2, 1, True),
    "qwen_tiny": (j_model, model, JEncoderConfig.tiny(), EncoderConfig.tiny(), 4, 2, False),
    "gemma": (j_gemma, gemma, JGemmaConfig(**GEMMA), GemmaEncoderConfig(**GEMMA), 2, 1, False),
    "gemma_local": (j_gemma, gemma, JGemmaConfig(**{**GEMMA, "num_heads": 4, "num_kv_heads": 2}),
                    GemmaEncoderConfig(**{**GEMMA, "num_heads": 4, "num_kv_heads": 2}), 2, 1, True),
    "gemma_tiny": (j_gemma, gemma, JGemmaConfig.tiny(), GemmaEncoderConfig.tiny(), 8, 1, False),
    "bert_tiny": (j_bert, bert, JBertConfig.tiny(), BertEncoderConfig.tiny(), 8, 1, False),
    "bert_local": (j_bert, bert, JBertConfig.tiny(), BertEncoderConfig.tiny(), 2, 2, True),
}


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _carry(jmod, jcfg, seed=0):
    """JAX params with gemma's zero-init (1 + w) norm weights moved off
    zero, and the port's copy."""
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(seed))
    if jmod is j_gemma:
        rng = np.random.default_rng(seed)
        for layer in jp["layers"]:
            for k in [k for k in layer if k.endswith("norm")]:
                layer[k] = jnp.asarray(0.2 * rng.standard_normal(layer[k].shape), jnp.float32)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _meshes(shard, data):
    return j_make_mesh(JMeshConfig(data=data, shard=shard)), cpu_mesh(shard, data=data)


def _batch(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(4, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_encode_pooled_matches_jax_sharded_forward(case):
    """The pooled embeddings of one batch through the port's tp forward
    ("on" and "off") at cosine >= 0.999 against JAX's forward on its
    sharded params, and >= 0.9999 against the port's own unsharded forward."""
    jmod, mod, jcfg, cfg, shard, data, local = CASES[case]
    if local:      # the case takes the head-local layout
        assert (cfg.num_heads if mod is bert else cfg.num_kv_heads) % shard == 0
    jp, tp = _carry(jmod, jcfg)
    jmesh, mesh = _meshes(shard, data)
    ts = mod.shard_params(tp, mesh)
    ids, mask = _batch(8, 32, cfg.vocab_size, seed=1)
    # one program, as the JAX package's encoders run it: op by op its forward
    # dispatches hundreds of small collective programs over the 8 CPU devices
    # without waiting, and under load XLA:CPU's rendezvous between them can
    # deadlock (7 of 8 devices arrive; its 40 s watchdog aborts the process)
    encode = jax.jit(functools.partial(jmod.encode_pooled, cfg=jcfg))
    want = np.asarray(encode(jmod.shard_params(jp, jmesh), jnp.asarray(ids), jnp.asarray(mask)))
    for fused in ("on", "off"):
        got = mod.encode_pooled(ts, torch.from_numpy(ids), torch.from_numpy(mask), cfg, fused=fused)
        one = mod.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg, fused=fused)
        assert got.shape == want.shape and got.device == mesh.first_device
        assert _cos(got.numpy(), want).min() >= 0.999, (fused, _cos(got.numpy(), want).min())
        assert _cos(got.numpy(), one.numpy()).min() >= 0.9999, fused


def _f32(params):
    out = {k: v.float() for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_forward_in_f32_is_the_unsharded_function(case):
    """In f32 throughout (params, activations, the reference composition)
    the tp forward and the unsharded one agree to f32 rounding, a largest
    row distance of the pooled unit rows <= 1e-5: the bf16 gates above
    leave room for rounding that grows with depth, this one leaves none
    for a head, block or sum misplaced."""
    _, mod, _, cfg, shard, data, _ = CASES[case]
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = _f32(mod.init_params(cfg32, torch.Generator().manual_seed(5), device="cpu"))
    if mod is gemma:       # the (1 + w) norm weights off zero
        for layer in params["layers"]:
            for k in [k for k in layer if k.endswith("norm")]:
                layer[k] = 0.2 * torch.randn(layer[k].shape, generator=torch.Generator().manual_seed(6))
    ids, mask = (torch.from_numpy(a) for a in _batch(8, 32, cfg.vocab_size, seed=2))
    one = mod.encode_pooled(params, ids, mask, cfg32, fused="off")
    got = mod.encode_pooled(mod.shard_params(params, cpu_mesh(shard, data=data)), ids, mask, cfg32,
                            fused="off")
    assert got.dtype == one.dtype == torch.float32
    assert float((got.double() - one.double()).norm(dim=1).max()) <= 1e-5


@pytest.mark.parametrize("case", ["qwen_local", "qwen_tiny", "gemma_tiny", "bert_tiny"])
def test_batched_encoder_tp_matches_jax(case):
    """BatchedEncoder(shard_params(params, mesh), cfg, mesh=mesh) against the
    reference's on its sharded params (cosine >= 0.999, the reference's
    own tp gate) and the port's single-device encoder (>= 0.9999), over
    texts of several lengths and batch buckets."""
    jmod, mod, jcfg, cfg, shard, data, _ = CASES[case]
    jp, tp = _carry(jmod, jcfg, seed=3)
    jmesh, mesh = _meshes(shard, data)
    texts = [f"theorem {i} on {'graded ' * (i % 7)}modules over rings" for i in range(13)]
    want = JBatchedEncoder(jmod.shard_params(jp, jmesh), jcfg, mesh=jmesh, batch_size=8).encode(texts)
    enc = BatchedEncoder(mod.shard_params(tp, mesh), cfg, mesh=mesh, batch_size=8)
    got = enc.encode(texts)
    one = BatchedEncoder(tp, cfg, device="cpu", batch_size=8).encode(texts)
    assert got.shape == want.shape == (13, cfg.embedding_dim)
    assert _cos(got, want).min() >= 0.999
    assert _cos(got, one).min() >= 0.9999
    dev = enc.encode_device(texts[:3])
    assert dev.device == mesh.first_device
    assert _cos(dev[:3].numpy(), got[:3]).min() >= 0.9999


def test_int8_on_a_tp_mesh_raises_in_both_packages():
    """int8 (w8a8) runs single-device or data-parallel only: both packages
    refuse it on a mesh with shard > 1 ("dp-only"), full or sharded
    params, and so does the port's forward on sharded params."""
    jmod, mod, jcfg, cfg, shard, data, _ = CASES["qwen_tiny"]
    jp, tp = _carry(jmod, jcfg)
    jmesh, mesh = _meshes(shard, data)
    with pytest.raises(ValueError, match="dp-only"):
        JBatchedEncoder(jp, jcfg, mesh=jmesh, quant="int8")
    ts = mod.shard_params(tp, mesh)
    for params in (tp, ts):
        with pytest.raises(ValueError, match="dp-only"):
            BatchedEncoder(params, cfg, mesh=mesh, quant="int8")
    ids, mask = (torch.from_numpy(x) for x in _batch(4, 16, cfg.vocab_size, seed=2))
    with pytest.raises(ValueError, match="dp-only"):
        mod.encode_pooled(ts, ids, mask, cfg, qlayers=mod.quantize_params_int8(tp))
    # a one-way shard axis is data parallel: int8 works on its placement
    dp = cpu_mesh(1, data=2)
    out = BatchedEncoder(mod.shard_params(tp, dp), cfg, mesh=dp, quant="int8").encode(["a b", "c"])
    ref = BatchedEncoder(tp, cfg, device="cpu", quant="int8").encode(["a b", "c"])
    assert _cos(out, ref).min() >= 0.9999
