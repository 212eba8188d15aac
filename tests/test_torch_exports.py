"""The port's public names: every name of every reference subpackage's
`__all__` imports from the port's subpackage of the same name, and the
public definitions behind them compute what the reference's do on the
same inputs (the encoder wrappers with carried weights on the tiny
configs, l2_normalize, int8_scores, FlatIndex.device_arrays and the plain
exact top-k of xla_mips_topk / xla_mips_topk_scan)."""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "theoremsearch_tpu"


def _ref_all(init: Path) -> list[str]:
    """The names in an __init__'s __all__, read from its source."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "__all__":
            return [e.value for e in node.value.elts]
    return []


SUBPACKAGES = sorted(
    ".".join(p.parent.relative_to(REF).parts) for p in REF.rglob("__init__.py")
    if p.parent != REF and _ref_all(p))


def test_subpackage_list_is_the_reference_api():
    assert {"core", "encoder", "eval", "index", "ingest", "kernels", "search", "serve",
            "slogans", "train", "utils"} <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_public_name_imports_from_the_port(sub):
    names = _ref_all(REF.joinpath(*sub.split("."), "__init__.py"))
    port = importlib.import_module(f"theoremsearch_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"theoremsearch_tpu_torch.{sub} lacks {missing}"
    assert set(names) <= set(port.__all__), set(names) - set(port.__all__)
    ref = importlib.import_module(f"theoremsearch_tpu.{sub}")
    for n in names:     # the same kind of object: a class for a class, a function for a function
        assert isinstance(getattr(port, n), type) == isinstance(getattr(ref, n), type), n


# ------------------------------------------------------- encoder wrappers


def _batch(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(4, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("family", ["qwen", "gemma", "bert"])
def test_encoder_wrappers_match_the_reference(family):
    """QwenEncoder, GemmaEncoder and BertEncoder on their tiny configs,
    the reference's weights carried over: pooled cosine >= 0.9999 on
    ragged batches; with no params each wrapper draws its own."""
    from theoremsearch_tpu import encoder as JE
    from theoremsearch_tpu.encoder import bert as JB
    from theoremsearch_tpu.encoder import gemma as JG
    from theoremsearch_tpu.encoder import model as JM
    from theoremsearch_tpu_torch import encoder as PE
    from theoremsearch_tpu_torch.core.config import (
        BertEncoderConfig, EncoderConfig, GemmaEncoderConfig,
    )
    from theoremsearch_tpu_torch.encoder import bert as PB
    from theoremsearch_tpu_torch.encoder import gemma as PG
    from theoremsearch_tpu_torch.encoder import model as PM

    jcfg, cfg, jmod, pmod, name = {
        "qwen": (JEncoderConfig.tiny(), EncoderConfig.tiny(), JM, PM, "QwenEncoder"),
        "gemma": (JGemmaConfig.tiny(), GemmaEncoderConfig.tiny(), JG, PG, "GemmaEncoder"),
        "bert": (JBertConfig.tiny(), BertEncoderConfig.tiny(), JB, PB, "BertEncoder"),
    }[family]
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(7))
    if family == "gemma":   # the zero-init (1 + w) norm weights moved off zero
        keys = iter(jax.random.split(jax.random.PRNGKey(107), 1000))
        jp = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape, a.dtype)
                          if a.ndim == 1 else a, jp)
    ref_enc = getattr(JE, name)(jcfg, params=jp)
    enc = getattr(PE, name)(cfg, params=pmod.params_from_jax(jax.device_get(jp), device="cpu"),
                            device="cpu")
    ids, mask = _batch(6, 24, cfg.vocab_size, seed=8)
    ref = np.asarray(ref_enc(jnp.asarray(ids), jnp.asarray(mask)))
    out = enc(ids, mask)
    assert isinstance(out, torch.Tensor) and out.shape == ref.shape == (6, cfg.embedding_dim)
    c = _cos(out.numpy(), ref)
    assert (c > 0.9999).all(), c
    # tensors in, the same answer; the default config is the full-width one
    np.testing.assert_array_equal(enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
                                  out.numpy())
    assert type(getattr(PE, name).default_config()) is type(cfg)
    own = getattr(PE, name)(cfg, seed=3, device="cpu")
    emb = own(ids, mask).numpy()
    assert emb.shape == (6, cfg.embedding_dim) and np.isfinite(emb).all()


# ------------------------------------------- the index and oracle helpers


def test_l2_normalize_and_int8_scores_match_the_reference():
    from theoremsearch_tpu.eval.oracle import l2_normalize as j_l2
    from theoremsearch_tpu.index.quant import int8_scores as j_scores
    from theoremsearch_tpu.index.quant import quantize_int8 as j_quant
    from theoremsearch_tpu_torch.eval.oracle import l2_normalize
    from theoremsearch_tpu_torch.index.quant import int8_scores, quantize_int8

    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 48)).astype(np.float32)
    x[5] = 0.0                                  # the eps floor keeps a zero row zero
    got = l2_normalize(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_l2(x)), rtol=2e-7, atol=1e-7)
    assert not got[5].any()
    np.testing.assert_allclose(l2_normalize(x, axis=0).numpy(), np.asarray(j_l2(x, axis=0)),
                               rtol=2e-7, atol=1e-7)
    q = rng.standard_normal((9, 48)).astype(np.float32)
    codes, scales = quantize_int8(torch.from_numpy(got.numpy()), device="cpu")
    jcodes, jscales = j_quant(np.asarray(j_l2(x)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    ref = np.asarray(j_scores(jnp.asarray(q), jnp.asarray(jcodes), jnp.asarray(jscales)))
    out = int8_scores(q, codes, scales)
    assert out.shape == (9, 37) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_flat_index_device_arrays(dtype):
    from theoremsearch_tpu_torch.core.config import IndexConfig
    from theoremsearch_tpu_torch.index.flat import FlatIndex

    x = np.random.default_rng(1).standard_normal((50, 16)).astype(np.float32)
    idx = FlatIndex.build(x, ids=np.arange(100, 150), config=IndexConfig(dtype=dtype, pad_multiple=16),
                          device="cpu")
    jidx = JFlatIndex.build(x, ids=np.arange(100, 150), config=JIndexConfig(dtype=dtype, pad_multiple=16))
    vecs, ids, scales = idx.device_arrays(device="cpu")
    jvecs, jids, jscales = jidx.device_arrays()
    assert ids.dtype == torch.int32 and str(jids.dtype) == "int32"
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert vecs.shape == tuple(jvecs.shape) == (64, 16)
    np.testing.assert_allclose(vecs.float().numpy(), np.asarray(jvecs, np.float32), atol=1e-6)
    assert (scales is None) == (jscales is None) == (dtype != "int8")
    if scales is not None:
        np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_xla_mips_topk_matches_the_reference(dtype):
    """The reference's plain exact top-k (xla_mips_topk, and the chunked
    xla_mips_topk_scan with per-query bias groups) against the port's:
    the same ids where scores are unique, scores within 1e-5."""
    from torch_helpers import ids_agree

    from theoremsearch_tpu.kernels import mips as JK
    from theoremsearch_tpu_torch.kernels import xla_mips_topk, xla_mips_topk_scan

    rng = np.random.default_rng(2)
    n, d, b, k = 512, 32, 6, 7
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    scales = None
    if dtype == "int8":
        amax = np.abs(x).max(axis=1)
        scales = (amax / 127.0).astype(np.float32)
        corpus = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
        tc, jc = torch.from_numpy(corpus), jnp.asarray(corpus)
    elif dtype == "bfloat16":
        tc = torch.from_numpy(x).to(torch.bfloat16)
        jc = jnp.asarray(x, jnp.bfloat16)
    else:
        tc, jc = torch.from_numpy(x), jnp.asarray(x)
    ts = None if scales is None else torch.from_numpy(scales)
    js = None if scales is None else jnp.asarray(scales)
    bias = np.where(rng.random(n) < 0.3, -np.inf, 0.0).astype(np.float32)
    for n_valid, bs in ((None, None), (400, bias)):
        s, i = xla_mips_topk(torch.from_numpy(q), tc, ts, n_valid,
                             None if bs is None else torch.from_numpy(bs), k=k)
        js_, ji = JK.xla_mips_topk(jnp.asarray(q), jc, js, n_valid,
                                   None if bs is None else jnp.asarray(bs), k=k)
        ids_agree(np.asarray(js_), np.asarray(ji), s, i, where=f"{dtype} n_valid={n_valid}")
    groups = np.where(rng.random((3, n)) < 0.5, -np.inf, 0.0).astype(np.float32)
    mask_ids = np.array([0, 2, 1, 2, 0, 0], np.int32)
    s, i = xla_mips_topk_scan(torch.from_numpy(q), tc, ts, 500, k=k, chunk=128,
                              bias_groups=torch.from_numpy(groups), mask_ids=torch.from_numpy(mask_ids))
    js_, ji = JK.xla_mips_topk_scan(jnp.asarray(q), jc, js, 500, k=k, chunk=128,
                                    bias_groups=jnp.asarray(groups), mask_ids=jnp.asarray(mask_ids))
    ids_agree(np.asarray(js_), np.asarray(ji), s, i, where=f"{dtype} groups")
    with pytest.raises(ValueError, match="multiple of chunk"):
        xla_mips_topk_scan(torch.from_numpy(q), tc, ts, k=k, chunk=100)
