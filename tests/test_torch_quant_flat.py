"""Port parity: global/per-row int8 quantization and the FlatIndex disk
format, theoremsearch_tpu_torch against the JAX reference."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.quant import quantize_global_int8 as j_quant_g
from theoremsearch_tpu.index.quant import quantize_int8 as j_quant_row
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.quant import dequantize_int8, quantize_global_int8, quantize_int8

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()


def _ties(scale: float) -> np.ndarray:
    """Rows whose x / scale are exact .5 ties (and the absmax 127*scale),
    so round-half-to-even vs half-away-from-zero shows in the codes."""
    k = np.arange(-126, 127, dtype=np.float32)
    row = np.concatenate([(k + 0.5) * np.float32(scale), [np.float32(127 * scale)]])
    rng = np.random.default_rng(3)
    return np.stack([rng.permutation(row) for _ in range(6)]).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.25, 1 / 128])
def test_global_int8_ties_bit_equal(scale):
    x = _ties(scale)
    codes, s = quantize_global_int8(x)
    jc, js = j_quant_g(x)
    assert s == js
    np.testing.assert_array_equal(codes.numpy(), jc)
    # half to even, explicitly: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0
    want = np.clip(np.rint(x / np.float32(js)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(codes.numpy(), want)


@pytest.mark.parametrize("clip_pct", [100.0, 99.9])
def test_global_int8_random_bit_equal(clip_pct):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    codes, s = quantize_global_int8(x, clip_pct=clip_pct)
    jc, js = j_quant_g(x, clip_pct=clip_pct)
    assert s == js
    np.testing.assert_array_equal(codes.numpy(), jc)


def test_dequantize_global_and_perrow():
    x = np.random.default_rng(6).standard_normal((40, 32)).astype(np.float32)
    codes, s = quantize_global_int8(x)
    np.testing.assert_array_equal(dequantize_int8(codes, s).numpy(),
                                  codes.numpy().astype(np.float32) * np.float32(s))
    assert np.abs(dequantize_int8(codes, s).numpy() - x).max() <= s / 2 + 1e-7
    rc, rs = quantize_int8(x)
    np.testing.assert_allclose(dequantize_int8(rc, rs).numpy(), x, atol=float(rs.max()) / 2 + 1e-7)


def test_perrow_int8_bit_equal():
    rng = np.random.default_rng(1)
    x = np.concatenate([_ties(0.25), rng.standard_normal((50, 254)).astype(np.float32)])
    codes, scales = quantize_int8(x)
    jc, js = j_quant_row(x)
    np.testing.assert_array_equal(codes.numpy(), jc)
    np.testing.assert_array_equal(scales.numpy(), js)


_CONFIGS = [
    dict(dtype="int8", int8_scale="global"),
    dict(dtype="int8", int8_scale="perrow"),
    dict(dtype="bfloat16"),
    dict(dtype="float32"),
]


def _emb(n=700, d=64, seed=2):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("cfg", _CONFIGS)
def test_jax_saved_index_loads_in_port(tmp_path, cfg):
    emb = _emb()
    j = JFlatIndex.build(emb, config=JIndexConfig(pad_multiple=256, **cfg))
    j.save(tmp_path)
    p = FlatIndex.load(tmp_path)
    assert p.num_rows == j.num_rows and p.global_scale == j.global_scale
    assert p.config.to_dict() == j.config.to_dict()
    jv = np.asarray(j.vectors)
    pv = p.vectors.view(torch.int16).numpy().view(np.uint16) if cfg["dtype"] == "bfloat16" else p.vectors.numpy()
    np.testing.assert_array_equal(pv, jv.view(np.uint16) if cfg["dtype"] == "bfloat16" else jv)
    np.testing.assert_array_equal(p.ids.numpy(), j.ids)
    if j.scales is None:
        assert p.scales is None
    else:
        np.testing.assert_array_equal(p.scales.numpy(), j.scales)


@pytest.mark.parametrize("cfg", _CONFIGS)
def test_port_saved_index_loads_in_jax(tmp_path, cfg):
    emb = _emb(seed=4)
    p = FlatIndex.build(emb, ids=np.arange(700) * 3, config=IndexConfig(pad_multiple=256, **cfg),
                        device="cpu")
    p.save(tmp_path)
    j = JFlatIndex.load(tmp_path)
    assert j.num_rows == p.num_rows and j.global_scale == p.global_scale
    assert j.vectors.shape == tuple(p.vectors.shape)
    if cfg["dtype"] == "bfloat16":
        np.testing.assert_array_equal(
            np.asarray(j.vectors).view(np.uint16), p.vectors.view(torch.int16).numpy().view(np.uint16))
    else:
        np.testing.assert_array_equal(np.asarray(j.vectors), p.vectors.numpy())
    np.testing.assert_array_equal(j.ids, p.ids.numpy())


def test_build_matches_jax_build():
    """Normalization (f64 sums, one f32 reciprocal per row) plus the global
    quantizer give the reference's codes and scale."""
    emb = _emb(n=2000, d=128, seed=5)
    cfg = dict(dtype="int8", int8_scale="global", pad_multiple=1024)
    j = JFlatIndex.build(emb, config=JIndexConfig(**cfg))
    p = FlatIndex.build(emb, config=IndexConfig(**cfg), device="cpu")
    assert p.global_scale == j.global_scale
    np.testing.assert_array_equal(p.vectors.numpy(), j.vectors)
    np.testing.assert_array_equal(p.scales.numpy(), j.scales)
