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
from theoremsearch_tpu_torch.encoder.model import (
    _rope_tables,
    encode_pooled,
    init_params,
    quantize_params_int8,
)
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.quant import quantize_global_int8
from theoremsearch_tpu_torch.kernels.attention import (
    attention_launches,
    fused_qknorm_rope_attention,
    fused_qknorm_rope_attention_plain,
)
from theoremsearch_tpu_torch.kernels.layer_int8 import (
    attn_int8_launches,
    fused_attn_int8_layer,
    fused_attn_int8_layer_plain,
    fused_mlp_int8_layer,
    fused_mlp_int8_layer_plain,
    kernel_layout,
    mlp_int8_launches,
    rmsnorm_quant_plain,
)
from theoremsearch_tpu_torch.kernels.mips import (
    mips_g_gmask_launches,
    mips_g_launches,
    mips_g_mask_launches,
    mips_g_scan,
    mips_g_scan_plain,
    mips_topk,
    mips_topk_launches,
    mips_topk_plain,
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


def _mask(kind, n, g):
    m = torch.zeros(n, dtype=torch.int8)
    if kind == "range":
        m[n // 5 : n // 2] = 1
    elif kind == "stripe":
        m[3::22] = 1
    elif kind == "three":
        m[[17, n // 3, n - 200]] = 1
    elif kind == "random":
        m = (torch.rand(n, generator=g) < 0.3).to(torch.int8)
    return m                                   # "none": all excluded


@pytest.mark.parametrize("kind", ["range", "stripe", "three", "none", "random"])
@pytest.mark.parametrize("n,d,rb,nv,m,b", [
    (16384, 128, 512, 16000, 2, 100),
    (16384, 1024, 4096, 16384, 4, 64),
])
def test_mips_g_masked_kernel_bit_equal_plain(cuda, kind, n, d, rb, nv, m, b):
    g = torch.Generator().manual_seed(n + d)
    codes = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8).to(cuda)
    q8 = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8).to(cuda)
    mask = _mask(kind, n, g).to(cuda)
    before = mips_g_mask_launches.n
    ck = mips_g_scan(q8, codes, nv, rb, m, mask=mask)
    assert mips_g_mask_launches.n == before + 1
    torch.testing.assert_close(ck, mips_g_scan_plain(q8, codes, nv, rb, m, mask=mask), rtol=0, atol=0)


@pytest.mark.parametrize("n_masks", [1, 3, 8, 32, 128])
def test_mips_g_gmask_kernel_bit_equal_plain(cuda, n_masks):
    g = torch.Generator().manual_seed(n_masks)
    n, d, rb, b = 16384, 256, 1024, 130
    codes = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8).to(cuda)
    q8 = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8).to(cuda)
    kinds = ["range", "stripe", "three", "none", "random"]
    gm = torch.stack([_mask(kinds[i % 5], n, g) for i in range(n_masks)]).to(cuda)
    ids = torch.randint(-1, n_masks + 1, (b,), generator=g, dtype=torch.int32).to(cuda)
    before = mips_g_gmask_launches.n
    ck = mips_g_scan(q8, codes, n - 5, rb, 2, gmasks=gm, mask_ids=ids)
    assert mips_g_gmask_launches.n == before + 1
    cp = mips_g_scan_plain(q8, codes, n - 5, rb, 2, gmasks=gm, mask_ids=ids)
    torch.testing.assert_close(ck, cp, rtol=0, atol=0)


def _topk_inputs(cuda, dtype, n, d, b, seed, dup=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    if dup:
        x[100:140] = x[7]                      # duplicate rows: exact ties
    q = torch.randn((b, d), generator=g)
    q[0] = x[7]
    if dtype == torch.int8:
        amax = x.abs().amax(1, keepdim=True)
        corpus = torch.round(x / (amax / 127)).clamp(-127, 127).to(torch.int8)
        scales = (amax[:, 0] / 127).float()
        qk = quantize_queries(q)[0]
    else:
        corpus, scales, qk = x.to(dtype), None, q.to(dtype)
    bias = torch.where(torch.rand(n, generator=g) < 0.4, float("-inf"), 0.0)
    to = (lambda t: None if t is None else t.to(cuda).contiguous())
    return to(qk), to(corpus), to(scales), to(bias)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 10, 40, 64, 65, 400, 1024])
@pytest.mark.parametrize("with_bias", [False, True])
def test_mips_topk_kernel_matches_plain(cuda, dtype, k, with_bias):
    n, d, b, nv = 20480, 256, 70, 20400
    qk, corpus, scales, bias = _topk_inputs(cuda, dtype, n, d, b, seed=k)
    bias = bias if with_bias else None
    before = mips_topk_launches.n
    sk, ik = mips_topk(qk, corpus, scales, nv, bias, k)
    assert mips_topk_launches.n == before + 1
    sp, ip = mips_topk_plain(qk, corpus, scales, nv, bias, k)
    if dtype == torch.int8:                     # exact sums: bit-equal, same tie rule
        torch.testing.assert_close(sk, sp, rtol=0, atol=0)
        torch.testing.assert_close(ik, ip, rtol=0, atol=0)
        return
    # f32 sums in other orders: scores within 1e-5, ids equal except
    # where a neighbouring score is within 1e-5
    fin = torch.isfinite(sp)
    assert torch.equal(fin, torch.isfinite(sk))
    assert float((sk[fin] - sp[fin]).abs().max()) <= 1e-5 * max(1.0, float(sp[fin].abs().max()))
    near = torch.zeros_like(fin)
    gap = (sp[:, 1:] - sp[:, :-1]).abs() <= 1e-5
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True                          # the k-th slot's neighbour is outside the list
    assert torch.equal(ik[~near], ip[~near])


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


@pytest.mark.parametrize("cfg", [dict(dtype="int8"), dict(dtype="bfloat16")])
def test_exact_route_on_card_matches_cpu(cuda, cfg):
    from theoremsearch_tpu_torch.search.filters import SearchFilters
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

    rng = np.random.default_rng(1)
    emb = rng.standard_normal((8000, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((32, 128)).astype(np.float32)
    meta = CorpusMetadata.from_rows([{"year": 2000 + i % 20, "link": "https://arxiv.org/abs/1"}
                                     for i in range(8000)])
    idx = FlatIndex.build(emb, config=IndexConfig(**cfg))
    f = SearchFilters(year_range=(2003, 2006))
    engines = [SearchEngine(idx, meta=meta, rescore_vectors=emb, device=dv) for dv in ("cpu", cuda)]
    before = mips_topk_launches.n
    (s_c, i_c), (s_g, i_g) = (e.search_vectors(q, k=10, filters=f) for e in engines)
    assert mips_topk_launches.n == before + 1
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


def _int8_layer(cuda, seed, d=256, i=512):
    cfg = EncoderConfig(vocab_size=512, hidden_size=d, intermediate_size=i, num_layers=1,
                        num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=128,
                        embedding_dim=d)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    return cfg, params["layers"][0], kernel_layout(quantize_params_int8(params))[0]


def _agree(x, out, ref):
    """Kernel vs plain: the output and the block's own contribution
    (out - x) each at cosine > 0.9999, max abs <= 2e-2 * max|plain|."""
    for a, b in ((out, ref), (out.float() - x.float(), ref.float() - x.float())):
        a, b = a.double().flatten(), b.double().flatten()
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


@pytest.mark.parametrize("t,d,i", [(256, 256, 512), (4096, 256, 768), (70, 1024, 3072)])
def test_mlp_int8_kernel_matches_plain(cuda, t, d, i):
    """B4 vs its plain version; T = 70 takes the ragged token tile. The
    norm + quant codes are bit-equal."""
    cfg, layer, lq = _int8_layer(cuda, t, d, i)
    x = torch.randn((t, d), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    args = (x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
    stages, before = {}, mlp_int8_launches.n
    out = fused_mlp_int8_layer(*args, eps=cfg.rms_norm_eps, stages=stages)
    assert mlp_int8_launches.n == before + 1
    ref = fused_mlp_int8_layer_plain(*args, eps=cfg.rms_norm_eps)
    xq, sx = rmsnorm_quant_plain(x, layer["mlp_norm"], cfg.rms_norm_eps)
    assert torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
    _agree(x, out, ref)


@pytest.mark.parametrize("b,s", [(8, 32), (4, 128), (6, 17)])
def test_attn_int8_kernel_matches_plain(cuda, b, s):
    """B3 (norm + quant, q/k/v products, B2's core, requant, o product)
    vs its plain version on ragged masks; norm + quant codes bit-equal."""
    cfg, layer, lq = _int8_layer(cuda, s)
    g = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn((b, s, cfg.hidden_size), generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    rope = _rope_tables(torch.clamp(mask.cumsum(1) - 1, min=0), cfg.head_dim, cfg.rope_theta)
    stages, before = {}, attn_int8_launches.n
    out = fused_attn_int8_layer(x, layer, lq, mask, rope, cfg, stages=stages)
    assert attn_int8_launches.n == before + 1
    ref = fused_attn_int8_layer_plain(x, layer, lq, mask, rope, cfg)
    xq, sx = rmsnorm_quant_plain(x.view(b * s, -1), layer["attn_norm"], cfg.rms_norm_eps)
    assert torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
    _agree(x, out, ref)


def test_int8_encoder_on_card_kernel_vs_plain(cuda):
    cfg = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=64, embedding_dim=256)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    ql = kernel_layout(quantize_params_int8(params))
    ids = torch.randint(3, 1024, (8, 32), device=cuda)
    mask = (torch.arange(32, device=cuda)[None] < torch.arange(25, 33, device=cuda)[:, None]).int()
    before = (attn_int8_launches.n, mlp_int8_launches.n)
    a = encode_pooled(params, ids, mask, cfg, qlayers=ql, fused_layers=True)
    assert (attn_int8_launches.n, mlp_int8_launches.n) == (before[0] + 2, before[1] + 2)
    b = encode_pooled(params, ids, mask, cfg, fused="plain", qlayers=ql, fused_layers=True)
    assert float((a.double() * b.double()).sum(1).min()) > 0.999


@pytest.mark.parametrize("b,c,r,d,p", [
    (8, 40, 256, 1024, 30),
    (13, 9, 128, 1024, 5),
    (8, 7, 512, 1024, 3),
    (64, 100, 256, 1024, 90),
    (100, 20, 128, 96, 12),
])
def test_ivf_scores_kernel_bit_equal_plain(cuda, b, c, r, d, p):
    from theoremsearch_tpu_torch.kernels.mips import (
        ivf_probe_scores, ivf_probe_scores_plain, ivf_scores_launches)

    g = torch.Generator().manual_seed(b + p)
    slabs = torch.randint(-127, 128, (c, r, d), generator=g, dtype=torch.int8)
    slabs[-1] = 0                                      # the empty fill chunk
    uids = torch.sort(torch.randint(0, c - 1, (p,), generator=g)).values.to(torch.int32)
    uids[-max(1, p // 4):] = c - 1                     # fills repeat the empty chunk
    q = torch.randn((b, d), generator=g)
    slabs, uids, q = slabs.to(cuda), uids.to(cuda), q.to(cuda)
    before = ivf_scores_launches.n
    ck, qk = ivf_probe_scores(q, slabs, uids)
    assert ivf_scores_launches.n == before + 1
    cp, qp = ivf_probe_scores_plain(q, slabs, uids)
    torch.testing.assert_close(ck, cp, rtol=0, atol=0)
    torch.testing.assert_close(qk, qp, rtol=0, atol=0)


def test_ivf_searcher_on_card_matches_cpu(cuda):
    from theoremsearch_tpu_torch.index.ivf import IVFIndex
    from theoremsearch_tpu_torch.kernels.mips import ivf_scores_launches

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 128)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, 32, 16384)] + (0.7 / np.sqrt(128)) * rng.standard_normal(
        (16384, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, 16384, 16)] + 0.05 * rng.standard_normal((16, 128)).astype(np.float32)
    idx_c = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=32, dtype="int8", ivf_assign2_margin=0.02),
                           slab_rows=768, normalize=False, device="cpu")
    idx_g = IVFIndex(**{f: getattr(idx_c, f) for f in (
        "centroids", "slabs", "slab_scales", "slab_ids", "spill", "spill_scales", "spill_ids",
        "num_rows", "config", "raw_flat", "res_flat", "res_scales_flat", "global_scale")}, device=cuda)
    before = ivf_scores_launches.n
    s_g, i_g = idx_g.device_searcher(k=10, nprobe=8, rescore_factor=8)(torch.from_numpy(q).to(cuda))
    assert ivf_scores_launches.n == before + 1
    s_c, i_c = idx_c.device_searcher(k=10, nprobe=8, rescore_factor=8)(torch.from_numpy(q))
    np.testing.assert_array_equal(i_g.cpu().numpy(), i_c.numpy())
    np.testing.assert_allclose(s_g.cpu().numpy(), s_c.numpy(), rtol=0, atol=1e-5)
