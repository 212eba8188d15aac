"""Port parity: the qwen checkpoint loader (encoder/loader.py:
config_from_hf, load_hf_checkpoint) on synthetic Qwen3-layout
safetensors checkpoints, read by the port's own numpy reader, against the
reference's loader (which uses the safetensors package); twins of
tests/test_loader.py."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu.encoder import loader as JLD
from theoremsearch_tpu.encoder.model import encode_pooled as jax_encode_pooled
from theoremsearch_tpu.encoder.tokenizer import SimpleTokenizer
from theoremsearch_tpu_torch.encoder import loader as LD
from theoremsearch_tpu_torch.encoder.model import encode_pooled

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(1)

CFG = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "rope_theta": 1000000.0, "rms_norm_eps": 1e-6}


def _qwen_tensors(rng, prefix="model."):
    """tests/test_loader.py's checkpoint, with the norm weights off one so
    a swapped norm would show."""
    H, I, Dh = CFG["hidden_size"], CFG["intermediate_size"], CFG["head_dim"]
    qdim, kvdim = Dh * CFG["num_attention_heads"], Dh * CFG["num_key_value_heads"]

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    t = {prefix + "embed_tokens.weight": (0.4 * w(512, H)), prefix + "norm.weight": norm(H)}
    for i in range(CFG["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        t |= {p + "input_layernorm.weight": norm(H), p + "self_attn.q_proj.weight": w(qdim, H),
              p + "self_attn.k_proj.weight": w(kvdim, H), p + "self_attn.v_proj.weight": w(kvdim, H),
              p + "self_attn.o_proj.weight": w(H, qdim), p + "self_attn.q_norm.weight": norm(Dh),
              p + "self_attn.k_norm.weight": norm(Dh), p + "post_attention_layernorm.weight": norm(H),
              p + "mlp.gate_proj.weight": w(I, H), p + "mlp.up_proj.weight": w(I, H),
              p + "mlp.down_proj.weight": w(H, I)}
    return t


def _write(path, tensors):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(CFG))
    safetensors_numpy.save_file(tensors, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def fake_checkpoint(tmp_path_factory):
    tensors = _qwen_tensors(np.random.default_rng(0))
    return _write(tmp_path_factory.mktemp("ckpt"), tensors), tensors


def _leaves(params):
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for i, layer in enumerate(params["layers"]):
        out |= {f"{i}.{k}": v for k, v in layer.items()}
    return out


def test_config_from_hf(fake_checkpoint):
    path, _ = fake_checkpoint
    cfg = LD.config_from_hf(path)
    assert cfg.hidden_size == 64 and cfg.num_layers == 2 and cfg.head_dim == 16
    assert cfg.num_kv_heads == 2 and cfg.vocab_size == 512
    assert cfg.to_dict() == JLD.config_from_hf(path).to_dict()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_and_encode_matches_the_reference(fake_checkpoint, dtype):
    path, tensors = fake_checkpoint
    params, cfg = LD.load_hf_checkpoint(path, dtype=dtype, device="cpu")
    jparams, jcfg = JLD.load_hf_checkpoint(path, dtype=dtype)
    got, want = _leaves(params), _leaves(jax.device_get(jparams))
    assert got.keys() == want.keys() and len(got) == 2 + 11 * 2
    for name, t in got.items():
        ref = np.asarray(want[name])
        assert str(t.dtype).split(".")[-1] == ref.dtype.name, name
        if ref.dtype.name == "bfloat16":      # compare the bits
            assert np.array_equal(t.view(torch.int16).numpy(), ref.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), ref), name
    # HF (out, in) transposed to (in, out)
    wq = params["layers"][0]["wq"]
    src = torch.from_numpy(tensors["model.layers.0.self_attn.q_proj.weight"]).to(wq.dtype)
    assert torch.equal(wq, src.T)
    # compute in the loaded dtype in both packages (the port's forward does
    # not promote bf16 activations against f32 weights as jnp does)
    cfg, jcfg = cfg.replace(dtype=dtype), jcfg.replace(dtype=dtype)
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    enc = tok(["loaded checkpoint forward", "a second, longer sentence about primes"], pad_to=16)
    out = encode_pooled(params, torch.from_numpy(enc.input_ids), torch.from_numpy(enc.attention_mask),
                        cfg).double().numpy()
    ref = np.asarray(jax_encode_pooled(jparams, enc.input_ids, enc.attention_mask, jcfg), np.float64)
    assert out.shape == (2, cfg.embedding_dim) and np.isfinite(out).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    assert float(np.min(np.sum(out * ref, axis=1))) > 0.9999


def test_bf16_checkpoint_keeps_its_bits_and_bare_keys_load(tmp_path):
    """A bf16 checkpoint in the bare Qwen3Model layout (no "model."
    prefix) with an lm_head: every leaf is the written tensor, bit for
    bit, transposed where HF stores (out, in); lm_head is skipped."""
    g = torch.Generator().manual_seed(3)
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16) + 0.01 * torch.randn(v.shape, generator=g
                                                                                ).to(torch.bfloat16)
               for k, v in _qwen_tensors(np.random.default_rng(1), prefix="").items()}
    tensors["lm_head.weight"] = torch.zeros((512, 64), dtype=torch.bfloat16)
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    safetensors_torch.save_file(tensors, str(tmp_path / "model.safetensors"))
    params, _ = LD.load_hf_checkpoint(tmp_path, device="cpu")
    names = {"embed": "embed_tokens.weight", "final_norm": "norm.weight"}
    for name, t in _leaves(params).items():
        if name in names:
            src = tensors[names[name]]
        else:
            i, key = name.split(".")
            sub = next(s for s, (k, _, _) in LD._QWEN_MAPPING.items() if k == key)
            src = tensors[f"layers.{i}.{sub}"]
            if LD._QWEN_MAPPING[sub][1]:
                src = src.T
        want = src.float() if t.dtype == torch.float32 else src
        assert t.dtype in (torch.bfloat16, torch.float32)
        assert torch.equal(t, want), name


def test_incomplete_checkpoint_raises(tmp_path, fake_checkpoint):
    src, _ = fake_checkpoint
    shutil.copy(src / "config.json", tmp_path / "config.json")
    safetensors_numpy.save_file({"model.embed_tokens.weight": np.zeros((512, 64), np.float32)},
                                str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        LD.load_hf_checkpoint(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        JLD.load_hf_checkpoint(tmp_path)
