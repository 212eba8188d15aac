"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test asks the `cuda` fixture for the device and skips
where there is none. This file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
from theoremsearch_tpu_torch.encoder.model import encode_pooled, init_params
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.quant import quantize_global_int8
from theoremsearch_tpu_torch.kernels.attention import (
    attention_launches,
    fused_qknorm_rope_attention,
    fused_qknorm_rope_attention_plain,
)
from theoremsearch_tpu_torch.kernels.mips import (
    mips_g_launches,
    mips_g_scan,
    mips_g_scan_plain,
    quantize_queries,
)
from theoremsearch_tpu_torch.search.engine import SearchEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,rb,nv,m,b", [
    (16384, 128, 512, 16384, 1, 16),
    (16384, 128, 512, 16000, 2, 100),
    (16384, 1024, 4096, 16001, 4, 8),
    (8192, 48, 128, 8190, 1, 65),
])
def test_mips_g_kernel_bit_equal_plain(cuda, n, d, rb, nv, m, b):
    g = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=cuda)
    x /= x.norm(dim=1, keepdim=True)
    codes, _ = quantize_global_int8(x)
    q8, _ = quantize_queries(torch.randn((b, d), generator=g, device=cuda))
    before = mips_g_launches.n
    ck = mips_g_scan(q8, codes, nv, rb, m)
    assert mips_g_launches.n == before + 1
    torch.testing.assert_close(ck, mips_g_scan_plain(q8, codes, nv, rb, m), rtol=0, atol=0)


@pytest.mark.parametrize("s", [1, 17, 64, 128])
def test_attention_kernel_matches_plain(cuda, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    b, h, hk, dh = 6, 4, 2, 128
    q = (torch.randn((b, s, h * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    v = torch.randn((b, s, hk * dh), generator=g, device=cuda).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((2, dh), generator=g, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    ang = torch.clamp(mask.cumsum(1) - 1, min=0)[..., None].float() * torch.rand((dh // 2,), device=cuda)
    kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=True)
    before = attention_launches.n
    out = fused_qknorm_rope_attention(q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask, **kw).float()
    assert attention_launches.n == before + 1
    ref = fused_qknorm_rope_attention_plain(
        q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask, scale=dh ** -0.5, **kw).float()
    o, r = out.double().flatten(), ref.double().flatten()
    cos = float(o @ r / (o.norm() * r.norm()))
    assert cos > 0.9999 and float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def test_engine_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((8192, 128)).astype(np.float32)
    q = rng.standard_normal((32, 128)).astype(np.float32)
    idx = FlatIndex.build(emb, config=IndexConfig(dtype="int8", int8_scale="global"))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    s_c, i_c = SearchEngine(idx, rescore_vectors=emb, device="cpu").search_vectors(q, k=10)
    s_g, i_g = SearchEngine(idx, rescore_vectors=emb, device=cuda).search_vectors(q, k=10)
    np.testing.assert_array_equal(i_g, i_c)
    np.testing.assert_allclose(s_g, s_c, rtol=1e-5)


def test_encoder_on_card_kernel_vs_plain(cuda):
    cfg = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    ids = torch.randint(3, 1024, (8, 32), device=cuda)
    mask = (torch.arange(32, device=cuda)[None] < torch.arange(25, 33, device=cuda)[:, None]).int()
    a = encode_pooled(params, ids, mask, cfg, fused="on")
    b = encode_pooled(params, ids, mask, cfg, fused="plain")
    assert float((a.double() * b.double()).sum(1).min()) > 0.9999
