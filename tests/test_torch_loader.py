"""Port parity: the gemma and BERT checkpoint loaders (encoder/loader.py)
on synthetic safetensors checkpoints, read by the port's own numpy reader,
against the reference's loaders (which use the safetensors package)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.encoder import bert as JB
from theoremsearch_tpu.encoder import gemma as JG
from theoremsearch_tpu.encoder import loader as JLD
from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
from theoremsearch_tpu_torch.encoder import bert as PB
from theoremsearch_tpu_torch.encoder import gemma as G
from theoremsearch_tpu_torch.encoder import loader as LD
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(1)

H, I, Dh, NH, NKV, L, V = 64, 128, 32, 2, 1, 4, 512
HEAD_HID, EMB = 96, 48


def _gemma_tensors(rng, prefix="model."):
    t = {prefix + "embed_tokens.weight": rng.standard_normal((V, H)).astype(np.float32) * 0.02,
         prefix + "norm.weight": 0.1 * rng.standard_normal(H).astype(np.float32)}
    shapes = {
        "input_layernorm.weight": (H,), "post_attention_layernorm.weight": (H,),
        "pre_feedforward_layernorm.weight": (H,), "post_feedforward_layernorm.weight": (H,),
        "self_attn.q_proj.weight": (Dh * NH, H), "self_attn.k_proj.weight": (Dh * NKV, H),
        "self_attn.v_proj.weight": (Dh * NKV, H), "self_attn.o_proj.weight": (H, Dh * NH),
        "self_attn.q_norm.weight": (Dh,), "self_attn.k_norm.weight": (Dh,),
        "mlp.gate_proj.weight": (I, H), "mlp.up_proj.weight": (I, H), "mlp.down_proj.weight": (H, I),
    }
    for i in range(L):
        for name, shape in shapes.items():
            t[f"{prefix}layers.{i}.{name}"] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return t


def _gemma_config(**extra):
    return {"model_type": "gemma3_text", "vocab_size": V, "hidden_size": H, "intermediate_size": I,
            "num_hidden_layers": L, "num_attention_heads": NH, "num_key_value_heads": NKV,
            "head_dim": Dh, "rope_theta": 1e6, "rope_local_base_freq": 1e4, "sliding_window": 16,
            "layer_types": ["sliding_attention", "full_attention"] * 2,
            "query_pre_attn_scalar": 32, "rms_norm_eps": 1e-6, "use_bidirectional_attention": True,
            **extra}


@pytest.fixture
def gemma_ckpt(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "config.json").write_text(json.dumps(_gemma_config()))
    tensors = _gemma_tensors(rng)
    safetensors_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    for name, (din, dout) in (("2_Dense", (H, HEAD_HID)), ("3_Dense", (HEAD_HID, EMB))):
        (tmp_path / name).mkdir()
        w = (0.05 * rng.standard_normal((dout, din))).astype(np.float32)
        b = (0.01 * rng.standard_normal(dout)).astype(np.float32)
        tensors[name] = (w, b)
        safetensors_numpy.save_file({"linear.weight": w, "linear.bias": b},
                                    str(tmp_path / name / "model.safetensors"))
    (tmp_path / "config_sentence_transformers.json").write_text(json.dumps(
        {"prompts": {"query": "task: search result | query: ", "document": "title: none | text: "}}))
    return tmp_path, tensors


def test_reader_round_trips_every_dtype(tmp_path):
    """Tensors written by safetensors come back bit-equal: f32, f16, bf16
    (as bits), the integer types and bool, scalars and empty shapes."""
    g = torch.Generator().manual_seed(1)
    want = {
        "f32": torch.randn((3, 5), generator=g), "f16": torch.randn((7,), generator=g).half(),
        "bf16": torch.randn((4, 4), generator=g).to(torch.bfloat16),
        "f64": torch.randn((2,), generator=g, dtype=torch.float64),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (2, 3), generator=g, dtype=torch.int32),
        "i64": torch.arange(5, dtype=torch.int64) - 2**40, "u8": torch.arange(6, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(3.5),
        "empty": torch.zeros((0, 4)),
    }
    path = tmp_path / "x.safetensors"
    safetensors_torch.save_file(want, str(path), metadata={"format": "pt"})
    got = LD.read_safetensors(path)
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k


def test_gemma_checkpoint_matches_the_references_loader(gemma_ckpt):
    path, tensors = gemma_ckpt
    assert LD.detect_family(path) == JLD.detect_family(path) == "gemma"
    assert LD.gemma_config_from_hf(path).__dict__ == JLD.gemma_config_from_hf(path).__dict__
    jp, jcfg = JLD.load_hf_gemma_checkpoint(path)
    tp, cfg = LD.load_hf_gemma_checkpoint(path, device="cpu")
    assert cfg.__dict__ == jcfg.__dict__ and (cfg.head_hidden, cfg.embedding_dim) == (HEAD_HID, EMB)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == 13 * L + 6
    for kp, a in flat:
        t = tp
        for k in kp:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert str(t.dtype).split(".")[1] == str(a.dtype), kp
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    np.testing.assert_array_equal(tp["head_b2"].numpy(), tensors["3_Dense"][1])
    ids, mask = np.array([[5, 9, 11, 0], [7, 8, 0, 0]], np.int32), np.array([[1, 1, 1, 0], [1, 1, 0, 0]])
    ref = np.asarray(JG.encode_pooled(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    out = G.encode_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    assert out.shape == (2, EMB)
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert (cos > 0.9999).all()
    assert LD.load_st_prompts(path) == JLD.load_st_prompts(path)
    enc = BatchedEncoder(tp, cfg, batch_size=8, prompts=LD.load_st_prompts(path))
    q = enc.encode(["prime gaps"], role="query")
    np.testing.assert_allclose(q, enc.encode(["task: search result | query: prime gaps"]), atol=1e-6)


def test_bf16_checkpoint_keeps_its_bits(tmp_path):
    """A bf16 tower (no 'model.' prefix, no head) loads bit for bit: bf16
    matrices stay bf16, bf16 norms become f32 exactly."""
    (tmp_path / "config.json").write_text(json.dumps(_gemma_config(layer_types=None,
                                                                   sliding_window_pattern=2)))
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in _gemma_tensors(np.random.default_rng(2), prefix="").items()}
    safetensors_torch.save_file(tensors, str(tmp_path / "model.safetensors"))
    tp, cfg = LD.load_hf_gemma_checkpoint(tmp_path, device="cpu")
    assert cfg.global_every == 2 and "head_w1" not in tp
    wq = tp["layers"][1]["wq"]
    assert wq.dtype == torch.bfloat16 and torch.equal(wq, tensors["layers.1.self_attn.q_proj.weight"].T)
    assert tp["final_norm"].dtype == torch.float32
    assert torch.equal(tp["final_norm"], tensors["norm.weight"].float())
    ids = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    assert G.encode_pooled(tp, ids, torch.ones_like(ids), cfg).shape == (1, H)


def test_incomplete_or_irregular_checkpoints_raise(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(_gemma_config()))
    tensors = _gemma_tensors(np.random.default_rng(3))
    del tensors["model.layers.2.mlp.up_proj.weight"]
    safetensors_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="incomplete"):
        LD.load_hf_gemma_checkpoint(tmp_path, device="cpu")
    (tmp_path / "config.json").write_text(json.dumps(_gemma_config(
        layer_types=["full_attention", "sliding_attention", "sliding_attention", "full_attention"])))
    with pytest.raises(ValueError, match="irregular"):
        LD.gemma_config_from_hf(tmp_path)


def test_bert_checkpoint_matches_the_references_loader(tmp_path):
    """A 'bert.'-prefixed BertModel checkpoint with a pooler: the same
    params as the reference's loader, and the same embeddings."""
    from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig

    jcfg = JBertConfig.tiny()
    jp = JB.init_params(jcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    hf = {"embed": "embeddings.word_embeddings.weight", "pos_embed": "embeddings.position_embeddings.weight",
          "type_embed": "embeddings.token_type_embeddings.weight",
          "embed_ln_g": "embeddings.LayerNorm.weight", "embed_ln_b": "embeddings.LayerNorm.bias"}
    sd = {f"bert.{v}": rng.standard_normal(np.shape(jp[k])).astype(np.float32) * 0.05
          for k, v in hf.items()}
    inv = {v[0]: k for k, v in LD._BERT_LAYER_MAPPING.items()}
    for i, layer in enumerate(jp["layers"]):
        for key, arr in layer.items():
            shape = np.shape(arr)[::-1] if len(np.shape(arr)) == 2 else np.shape(arr)
            sd[f"bert.encoder.layer.{i}.{inv[key]}"] = rng.standard_normal(shape).astype(np.float32) * 0.05
    sd["bert.pooler.dense.weight"] = np.zeros((jcfg.hidden_size, jcfg.hidden_size), np.float32)
    safetensors_numpy.save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "bert", "architectures": ["BertModel"], "vocab_size": jcfg.vocab_size,
        "hidden_size": jcfg.hidden_size, "intermediate_size": jcfg.intermediate_size,
        "num_hidden_layers": jcfg.num_layers, "num_attention_heads": jcfg.num_heads,
        "max_position_embeddings": jcfg.max_seq_len, "hidden_act": "gelu"}))
    assert LD.detect_family(tmp_path) == "bert"
    jl, jc = JLD.load_hf_bert_checkpoint(tmp_path)
    tl, tc = LD.load_hf_bert_checkpoint(tmp_path, device="cpu")
    assert tc.__dict__ == jc.__dict__
    for kp, a in jax.tree_util.tree_flatten_with_path(jl)[0]:
        t = tl
        for k in kp:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert str(t.dtype).split(".")[1] == str(a.dtype), kp
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    ids, mask = np.array([[5, 9, 11, 3]], np.int32), np.array([[1, 1, 1, 0]], np.int32)
    ref = np.asarray(JB.encode_pooled(jl, jnp.asarray(ids), jnp.asarray(mask), jc))
    out = PB.encode_pooled(tl, torch.from_numpy(ids), torch.from_numpy(mask), tc).numpy()
    assert float((out * ref).sum()) > 0.9999
