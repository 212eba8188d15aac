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
    _assert_b5_agrees(sk, ik, sp, ip, exact=dtype == torch.int8)


def _assert_b5_agrees(sk, ik, sp, ip, exact):
    """B5 kernel vs plain: int8 (exact sums) bit-equal scores and ids, the
    same tie rule; bf16/f32 (f32 sums in other orders) scores within 1e-5
    of max(1, max|plain|), ids equal except where a neighbouring score is
    within 1e-5."""
    if exact:
        torch.testing.assert_close(sk, sp, rtol=0, atol=0)
        torch.testing.assert_close(ik, ip, rtol=0, atol=0)
        return
    fin = torch.isfinite(sp)
    assert torch.equal(fin, torch.isfinite(sk))
    if bool(fin.any()):
        assert float((sk[fin] - sp[fin]).abs().max()) <= 1e-5 * max(1.0, float(sp[fin].abs().max()))
    near = torch.zeros_like(fin)
    gap = (sp[:, 1:] - sp[:, :-1]).abs() <= 1e-5
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True                          # the k-th slot's neighbour is outside the list
    assert torch.equal(ik[~near], ip[~near])


def _b5_sweep_inputs(cuda, kind, n, d, b, seed):
    """Unit rows, as the index holds them, with 40 copies of row 7 (exact
    ties) and query 0 equal to it: (queries, corpus, scales)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    x /= x.norm(dim=1, keepdim=True)
    x[100:140] = x[7]
    q = torch.randn((b, d), generator=g)
    q /= q.norm(dim=1, keepdim=True)
    q[0] = x[7]
    if kind == torch.int8:
        amax = x.abs().amax(1, keepdim=True)
        corpus = torch.round(x / (amax / 127)).clamp(-127, 127).to(torch.int8)
        qk, scales = quantize_queries(q)[0], (amax[:, 0] / 127).float().to(cuda)
    else:
        corpus, qk, scales = x.to(kind), q.to(kind), None
    return qk.to(cuda).contiguous(), corpus.to(cuda).contiguous(), scales


def _b5_bias(cuda, form, n, seed):
    """None; 40% of rows at -inf; a contiguous 30% window passing (a year
    filter); every row excluded; all but 3 rows excluded."""
    if form is None:
        return None
    g = torch.Generator().manual_seed(seed)
    b = torch.full((n,), float("-inf"))
    if form == "random":
        b = torch.where(torch.rand(n, generator=g) < 0.4, float("-inf"), 0.0)
    elif form == "window":
        b[int(0.4 * n):int(0.7 * n)] = 0.0
    elif form == "three":
        b[[5, n // 2, n - 90]] = 0.0
    return b.to(cuda)


def _check_b5(qk, corpus, scales, nv, bias, k):
    """One launch (the counter moves by one), a second one bit-equal to
    it, then the plain version's agreement."""
    before = mips_topk_launches.n
    sk, ik = mips_topk(qk, corpus, scales, nv, bias, k)
    assert mips_topk_launches.n == before + 1
    s2, i2 = mips_topk(qk, corpus, scales, nv, bias, k)
    assert torch.equal(sk, s2) and torch.equal(ik, i2)
    sp, ip = mips_topk_plain(qk, corpus, scales, nv, bias, k)
    _assert_b5_agrees(sk, ik, sp, ip, exact=corpus.dtype == torch.int8)


@pytest.mark.parametrize("kind", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 10, 40, 64, 65, 400, 1024])
@pytest.mark.parametrize("b", [1, 8, 64, 70, 512])
def test_mips_topk_kernel_over_k_and_batch(cuda, kind, k, b):
    """B5 at every query-tile form (64 queries for k <= 64, 16 above) and
    span split (one wave of blocks for any B), n_valid short of the
    padding, a 0 / -inf bias."""
    n, d = 20480, 256
    qk, corpus, scales = _b5_sweep_inputs(cuda, kind, n, d, b, seed=k * 1000 + b)
    _check_b5(qk, corpus, scales, n - 77, _b5_bias(cuda, "random", n, seed=b), k)


@pytest.mark.parametrize("kind", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [10, 40, 64])
def test_mips_topk_kernel_with_the_top_rows_in_first_groups(cuda, kind, k):
    """Query 0's 64 best rows, at distinct falling scores, lie in groups 2
    and 134, the first groups of span 2's two warpgroups (132 spans at B =
    8): the kernel's first-group bound (each query's exact k-th best score
    of the group) must keep every one of them that belongs in the top k."""
    n, d, b = 20480, 256, 8
    g = torch.Generator().manual_seed(k)
    x = torch.randn((n, d), generator=g)
    x /= x.norm(dim=1, keepdim=True)
    q = torch.randn((b, d), generator=g)
    q /= q.norm(dim=1, keepdim=True)
    rows = [256 + 4 * j for j in range(32)] + [134 * 128 + 4 * j for j in range(32)]
    for j, r in enumerate(rows):
        e = torch.randn(d, generator=g)
        e -= (e @ q[0]) * q[0]
        x[r] = q[0] + 0.02 * j * e / e.norm()
        x[r] /= x[r].norm()
    if kind == torch.int8:
        amax = x.abs().amax(1, keepdim=True)
        corpus = torch.round(x / (amax / 127)).clamp(-127, 127).to(torch.int8)
        qk, scales = quantize_queries(q)[0], (amax[:, 0] / 127).float().to(cuda)
    else:
        corpus, qk, scales = x.to(kind), q.to(kind), None
    _check_b5(qk.to(cuda).contiguous(), corpus.to(cuda).contiguous(), scales, n, None, k)


@pytest.mark.parametrize("kind", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [48, 768, 1024, 1040, 2048])
@pytest.mark.parametrize("form", [None, "random", "window", "none", "three"])
def test_mips_topk_kernel_over_dims_and_filters(cuda, kind, d, form):
    """B5 with the query tile resident or streamed (by D and kind) and
    whole groups skipped by the need map (all -inf groups, a contiguous
    window, all rows excluded, 3 rows left)."""
    n = 20480
    qk, corpus, scales = _b5_sweep_inputs(cuda, kind, n, d, 70, seed=d)
    _check_b5(qk, corpus, scales, n - 77, _b5_bias(cuda, form, n, seed=d), 40)


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


def test_attention_bwd_kernel_matches_plain_and_repeats_bit_equal(cuda):
    """B7 vs its plain version at one ragged shape (mask[:, 0] = 1, g zero
    on padded rows); a second launch is bit-equal to the first."""
    from theoremsearch_tpu_torch.kernels.attention import (
        attention_bwd_launches, fused_qknorm_rope_attention_bwd,
        fused_qknorm_rope_attention_bwd_plain)

    g_ = torch.Generator(device=cuda).manual_seed(7)
    b, s, h, hk, dh = 6, 48, 4, 2, 128
    q = (torch.randn((b, s, h * dh), generator=g_, device=cuda) * 0.5).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=g_, device=cuda) * 0.5).to(torch.bfloat16)
    v = (torch.randn((b, s, hk * dh), generator=g_, device=cuda) * 0.5).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((2, dh), generator=g_, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=g_, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    ang = torch.clamp(mask.cumsum(1) - 1, min=0)[..., None].float() * torch.rand((dh // 2,), device=cuda)
    gr = (torch.randn((b, s, h * dh), generator=g_, device=cuda) * mask[..., None]).to(torch.bfloat16)
    args = (q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask, gr)
    kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=True)
    before = attention_bwd_launches.n
    out = fused_qknorm_rope_attention_bwd(*args, **kw)
    again = fused_qknorm_rope_attention_bwd(*args, **kw)
    assert attention_bwd_launches.n == before + 2
    ref = fused_qknorm_rope_attention_bwd_plain(*args, scale=dh ** -0.5, **kw)
    for i, (o, o2, r) in enumerate(zip(out, again, ref)):
        assert torch.equal(o, o2) and o.dtype == r.dtype and o.shape == r.shape
        a, c = o.double().flatten(), r.double().flatten()
        tol = 2e-2 if i < 3 else 1e-3
        assert float(a @ c / (a.norm() * c.norm())) > 0.9999, i
        assert float((a - c).abs().max()) <= tol * float(c.abs().max()), i


def test_encoder_grads_on_card_reach_every_attention_weight(cuda):
    """encode_pooled(fused="on") on the card trains through B2 and B7:
    every layer's wq, wk, wv, q_norm and k_norm gets a nonzero, finite
    gradient, close to the plain path's."""
    from theoremsearch_tpu_torch.kernels.attention import attention_bwd_launches

    cfg = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)
    ids = torch.randint(3, 1024, (8, 32), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    mask = (torch.arange(32, device=cuda)[None] < torch.arange(25, 33, device=cuda)[:, None]).int()
    grads = {}
    for fused in ("on", "plain"):
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        for layer in params["layers"]:
            for t in layer.values():
                t.requires_grad_()
        before = attention_bwd_launches.n
        encode_pooled(params, ids, mask, cfg, fused=fused).sum().backward()
        assert attention_bwd_launches.n == before + (cfg.num_layers if fused == "on" else 0)
        grads[fused] = [{n: layer[n].grad for n in ("wq", "wk", "wv", "q_norm", "k_norm")}
                        for layer in params["layers"]]
    for lk, lp in zip(grads["on"], grads["plain"]):
        for name, gk in lk.items():
            assert gk is not None, name
            assert bool(torch.isfinite(gk.float()).all()) and float(gk.float().abs().max()) > 0, name
            a, c = gk.double().flatten(), lp[name].double().flatten()
            assert float(a @ c / (a.norm() * c.norm())) > 0.999, name


def test_int8_layers_refuse_grad(cuda):
    cfg, layer, lq = _int8_layer(cuda, 3)
    x = torch.randn((2, 16, cfg.hidden_size), device=cuda).to(torch.bfloat16).requires_grad_()
    mask = torch.ones((2, 16), dtype=torch.int32, device=cuda)
    rope = _rope_tables(torch.clamp(mask.cumsum(1) - 1, min=0), cfg.head_dim, cfg.rope_theta)
    with pytest.raises(ValueError, match="inference-only"):
        fused_mlp_int8_layer(x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])
    with pytest.raises(ValueError, match="inference-only"):
        fused_attn_int8_layer(x, layer, lq, mask, rope, cfg)
    with torch.no_grad():
        fused_mlp_int8_layer(x, layer["mlp_norm"], lq["w_gate"], lq["w_up"], lq["w_down"])


def test_train_steps_on_card_kernel_vs_plain(cuda):
    """Three train steps of the head_dim-128 encoder on the card, through
    B2 and B7 ("on") and through their plain versions: the losses within
    5e-3, the state on the card, B7 launched twice a step (two towers)."""
    from theoremsearch_tpu_torch.core.config import TrainConfig
    from theoremsearch_tpu_torch.kernels.attention import attention_bwd_launches
    from theoremsearch_tpu_torch.train.contrastive import init_train_state, make_train_step

    cfg = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)
    tcfg = TrainConfig(batch_size=8, seq_len=32, learning_rate=1e-3, temperature=1.0)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1024, (3, 2, 8, 32)).astype(np.int32)
    mask = (np.arange(32)[None] < rng.integers(8, 33, 8)[:, None]).astype(np.int32)
    mask[:, 0] = 1
    losses = {}
    for fused in ("on", "plain"):
        state = init_train_state(cfg, tcfg)
        assert state.params["embed"].device.type == "cuda"
        step = make_train_step(cfg, tcfg, fused=fused)
        before = attention_bwd_launches.n
        out = []
        for i in range(3):
            state, loss = step(state, ids[i, 0], mask, ids[i, 1], mask)
            assert loss.device.type == "cuda" and loss.dim() == 0
            out.append(float(loss))
        assert attention_bwd_launches.n - before == (3 * 2 * cfg.num_layers if fused == "on" else 0)
        losses[fused] = out
    assert all(np.isfinite(losses["on"]))
    np.testing.assert_allclose(losses["on"], losses["plain"], rtol=0, atol=5e-3)


# ---------------------------------------------------------------- gemma forms


GEMMA_SMALL = dict(vocab_size=1024, hidden_size=256, intermediate_size=384, num_layers=2,
                   num_heads=2, num_kv_heads=1, head_dim=256, global_every=2, max_seq_len=64,
                   head_hidden=256, embedding_dim=256, query_pre_attn_scalar=256.0)


def _gemma_params(cfg, device, seed=0):
    """Random gemma params with the (1 + w) norm weights off zero."""
    from theoremsearch_tpu_torch.encoder import gemma

    g = torch.Generator(device=device).manual_seed(seed)
    params = gemma.init_params(cfg, g, device=device)
    for layer in params["layers"]:
        for name, t in layer.items():
            if t.ndim == 1:
                t += 0.1 * torch.randn(t.shape, generator=g, device=device)
    return params


@pytest.mark.parametrize("s", [1, 17, 64, 128])
def test_attention_kernel_gemma_form_matches_plain(cuda, s):
    """B2 at head_dim 256, bidirectional, 3/1 heads, scale 256^-1/2, vs
    its plain version: cosine > 0.9999, max abs <= 2e-2 * max|plain|;
    the launch counts as the gemma form's."""
    from theoremsearch_tpu_torch.kernels.attention import attention_gemma_launches

    g = torch.Generator(device=cuda).manual_seed(s)
    b, h, hk, dh = 6, 3, 1, 256
    q = (torch.randn((b, s, h * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    v = torch.randn((b, s, hk * dh), generator=g, device=cuda).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((2, dh), generator=g, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    ang = torch.clamp(mask.cumsum(1) - 1, min=0)[..., None].float() * torch.rand((dh // 2,), device=cuda)
    kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=False, scale=256 ** -0.5)
    before = (attention_launches.n, attention_gemma_launches.n)
    out = fused_qknorm_rope_attention(q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask, **kw).float()
    assert (attention_launches.n, attention_gemma_launches.n) == (before[0], before[1] + 1)
    ref = fused_qknorm_rope_attention_plain(q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask, **kw).float()
    o, r = out.double().flatten(), ref.double().flatten()
    assert float(o @ r / (o.norm() * r.norm())) > 0.9999
    assert float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def _gemma_layer(cuda, seed, d=768, i=1152):
    from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
    from theoremsearch_tpu_torch.encoder import gemma

    cfg = GemmaEncoderConfig(vocab_size=512, hidden_size=d, intermediate_size=i, num_layers=1,
                             max_seq_len=128)
    params = _gemma_params(cfg, cuda, seed)
    return cfg, params["layers"][0], kernel_layout(gemma.quantize_params_int8(params))[0]


@pytest.mark.parametrize("t,d,i", [(256, 768, 1152), (70, 768, 1152), (4096, 256, 384)])
def test_mlp_int8_kernel_gemma_form_matches_plain(cuda, t, d, i):
    """B4's gemma form (GeGLU, post-norm) vs its plain version; the norm +
    quant codes bit-equal; counted as the gemma form."""
    from theoremsearch_tpu_torch.kernels.layer_int8 import mlp_int8_gemma_launches

    cfg, layer, lq = _gemma_layer(cuda, t, d, i)
    x = torch.randn((t, d), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    nw, pw = 1.0 + layer["pre_mlp_norm"], 1.0 + layer["post_mlp_norm"]
    args = (x, nw, lq["w_gate"], lq["w_up"], lq["w_down"], pw)
    stages, before = {}, (mlp_int8_launches.n, mlp_int8_gemma_launches.n)
    out = fused_mlp_int8_layer(*args, eps=cfg.rms_norm_eps, act="gelu_tanh", stages=stages)
    assert (mlp_int8_launches.n, mlp_int8_gemma_launches.n) == (before[0], before[1] + 1)
    ref = fused_mlp_int8_layer_plain(*args, eps=cfg.rms_norm_eps, act="gelu_tanh")
    xq, sx = rmsnorm_quant_plain(x, nw, cfg.rms_norm_eps)
    assert torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
    _agree(x, out, ref)


@pytest.mark.parametrize("b,s", [(8, 32), (4, 128), (6, 17)])
def test_attn_int8_kernel_gemma_form_matches_plain(cuda, b, s):
    """B3's gemma form (bidirectional head_dim-256 core, post-norm) vs its
    plain version on ragged masks; norm + quant codes bit-equal."""
    from theoremsearch_tpu_torch.encoder.gemma import _rope_tables as gemma_rope
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        attn_int8_gemma_launches,
        fused_attn_int8_layer_gemma,
        fused_attn_int8_layer_gemma_plain,
    )

    cfg, layer, lq = _gemma_layer(cuda, s)
    g = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn((b, s, cfg.hidden_size), generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    rope = gemma_rope(torch.clamp(mask.cumsum(1) - 1, min=0), cfg.head_dim, cfg.rope_local_theta)
    stages, before = {}, (attn_int8_launches.n, attn_int8_gemma_launches.n)
    out = fused_attn_int8_layer_gemma(x, layer, lq, mask, rope, cfg, stages=stages)
    assert (attn_int8_launches.n, attn_int8_gemma_launches.n) == (before[0], before[1] + 1)
    ref = fused_attn_int8_layer_gemma_plain(x, layer, lq, mask, rope, cfg)
    xq, sx = rmsnorm_quant_plain(x.view(b * s, -1), 1.0 + layer["attn_norm"], cfg.rms_norm_eps)
    assert torch.equal(stages["xq"], xq) and torch.equal(stages["sx"], sx[:, 0])
    _agree(x, out, ref)


def test_gemma_encoder_on_card_kernel_vs_plain(cuda):
    """The head_dim-256 gemma tower, bf16 and int8 whole layers, kernel
    path vs plain path: pooled cosine > 0.9999 (bf16), > 0.999 (int8)."""
    from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
    from theoremsearch_tpu_torch.encoder import gemma
    from theoremsearch_tpu_torch.kernels.attention import attention_gemma_launches

    cfg = GemmaEncoderConfig(**GEMMA_SMALL)
    params = _gemma_params(cfg, cuda)
    ids = torch.randint(3, 1024, (8, 32), device=cuda)
    mask = (torch.arange(32, device=cuda)[None] < torch.arange(25, 33, device=cuda)[:, None]).int()
    before = attention_gemma_launches.n
    a = gemma.encode_pooled(params, ids, mask, cfg, fused="on")
    assert attention_gemma_launches.n == before + cfg.num_layers
    b = gemma.encode_pooled(params, ids, mask, cfg, fused="plain")
    assert float((a.double() * b.double()).sum(1).min()) > 0.9999
    ql = kernel_layout(gemma.quantize_params_int8(params))
    a8 = gemma.encode_pooled(params, ids, mask, cfg, qlayers=ql, fused_layers=True)
    b8 = gemma.encode_pooled(params, ids, mask, cfg, fused="plain", qlayers=ql, fused_layers=True)
    assert float((a8.double() * b8.double()).sum(1).min()) > 0.999


def test_gemma_core_grad_fn_on_card(cuda):
    """The gemma core's ctypes output gets its grad_fn from
    GemmaAttentionCore: through fused="on" every layer's wq, wk, wv,
    q_norm and k_norm get a nonzero finite gradient close to the plain
    path's."""
    from theoremsearch_tpu_torch.core.config import GemmaEncoderConfig
    from theoremsearch_tpu_torch.encoder import gemma

    cfg = GemmaEncoderConfig(**GEMMA_SMALL)
    ids = torch.randint(3, 1024, (8, 32), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    mask = (torch.arange(32, device=cuda)[None] < torch.arange(25, 33, device=cuda)[:, None]).int()
    grads = {}
    for fused in ("on", "plain"):
        params = _gemma_params(cfg, cuda)
        for layer in params["layers"]:
            for t in layer.values():
                t.requires_grad_()
        out = gemma.encode_pooled(params, ids, mask, cfg, fused=fused)
        assert out.grad_fn is not None
        out.sum().backward()
        grads[fused] = [{n: layer[n].grad for n in ("wq", "wk", "wv", "q_norm", "k_norm")}
                        for layer in params["layers"]]
    for lk, lp in zip(grads["on"], grads["plain"]):
        for name, gk in lk.items():
            assert gk is not None, name
            assert bool(torch.isfinite(gk.float()).all()) and float(gk.float().abs().max()) > 0, name
            a, c = gk.double().flatten(), lp[name].double().flatten()
            assert float(a @ c / (a.norm() * c.norm())) > 0.999, name


# ---------------------------------------------------------------- serving uploads, recall gate


def test_serving_uploads_do_not_wait_for_queued_device_work(cuda):
    """The grouped dispatch (36 signatures: split 32 + 4, each with its
    row index and query -> mask-id uploads) and a mixed text + vector
    group (its row index and host vectors) return to the host while a
    long kernel is still queued: pinned, non-blocking uploads, where a
    pageable copy would wait for the queued work to finish."""
    import time

    from theoremsearch_tpu_torch.search.filters import SearchFilters
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from theoremsearch_tpu_torch.serve.scheduler import BatchScheduler

    rng = np.random.default_rng(2)
    emb = rng.standard_normal((16384, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    meta = CorpusMetadata.from_rows([{"year": 1980 + i % 40, "link": "https://arxiv.org/abs/1"}
                                     for i in range(16384)])
    engine = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8", int8_scale="global")),
                          meta=meta, rescore_vectors=emb, device=cuda)
    flist = [SearchFilters(year_range=(1980 + j, 1981 + j)) for j in range(36)] * 2
    q = torch.from_numpy(rng.standard_normal((72, 128)).astype(np.float32)).to(cuda)
    want = engine._dispatch_grouped(q, 10, flist)()            # warms the per-signature masks
    enc = torch.randn((8, 128), device=cuda)
    vecs = rng.standard_normal((3, 128)).astype(np.float32)
    BatchScheduler._group_queries(enc, [0, 2, 5], 8, vecs)
    torch.cuda.synchronize()

    def host_seconds(fn):
        torch.cuda._sleep(1_000_000_000)                        # ~0.5 s of queued device work
        t0 = time.perf_counter()
        out = fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t_host, time.perf_counter() - t0, out

    t_host, t_all, fin = host_seconds(lambda: engine._dispatch_grouped(q, 10, flist))
    assert t_all > 0.2 and t_host < 0.5 * t_all, (t_host, t_all)
    s, ids = fin()
    np.testing.assert_array_equal(ids, want[1])
    t_host, t_all, grouped = host_seconds(lambda: BatchScheduler._group_queries(enc, [0, 2, 5], 8, vecs))
    assert t_all > 0.2 and t_host < 0.5 * t_all, (t_host, t_all)
    torch.testing.assert_close(grouped[:3], enc[[0, 2, 5]])
    torch.testing.assert_close(grouped[3:6].cpu(), torch.from_numpy(vecs))


def test_recall_gate_on_the_card(cuda):
    """The verbatim harness's recall_gate runs its exact oracle on the
    card (the port's exact_topk default; the reference's runs on any
    backend): an exact answer scores 1.0, a shifted one less."""
    from theoremsearch_tpu_torch.eval.harness import recall_gate
    from theoremsearch_tpu_torch.eval.oracle import exact_topk

    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((5000, 64)).astype(np.float32)
    q = rng.standard_normal((32, 64)).astype(np.float32)
    _, ids = exact_topk(q, corpus, k=10, device="cpu")
    assert recall_gate(q, corpus, ids, k=10) == 1.0
    off = ids.copy()
    off[:, -1] = (off[:, -1] + 1) % 5000
    assert recall_gate(q, corpus, off, k=10) < 1.0


# ---- B2 on the tensor cores and the wgmma int8 product behind B3 / B4 ----


@pytest.mark.parametrize("form", ["qwen", "gemma"])
@pytest.mark.parametrize("s", [1, 7, 16, 33, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_attention_kernel_forms_over_s_and_groups(cuda, form, s, group):
    """B2 in both forms at S with a partial last key tile, one tile and
    many, for each GQA group H/Hk, on ragged masks (mask[:, 0] = 1, one
    item full, one with interior holes): cosine > 0.9999 and max abs <=
    2e-2 * max|plain|, and a second launch bit-equal to the first."""
    if form == "qwen":
        dh, hk, causal, scale = 128, 2, True, 128 ** -0.5
    else:
        dh, hk, causal, scale = 256, 1, False, 256 ** -0.5
    h, b = hk * group, 5
    g = torch.Generator(device=cuda).manual_seed(1000 * s + 10 * group + dh)
    q = (torch.randn((b, s, h * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=g, device=cuda) * 2).to(torch.bfloat16)
    v = torch.randn((b, s, hk * dh), generator=g, device=cuda).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((2, dh), generator=g, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    lens[0] = s
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    mask[1, 2::3] = 0
    mask[:, 0] = 1
    ang = torch.clamp(mask.cumsum(1) - 1, min=0)[..., None].float() * torch.rand(
        (dh // 2,), generator=g, device=cuda)
    kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=causal, scale=scale)
    args = (q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask)
    out = fused_qknorm_rope_attention(*args, **kw)
    again = fused_qknorm_rope_attention(*args, **kw)
    ref = fused_qknorm_rope_attention_plain(*args, **kw).float()
    assert torch.equal(out, again)
    o, r = out.double().flatten(), ref.double().flatten()
    assert float(o @ r / (o.norm() * r.norm())) > 0.9999
    assert float((out.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def _full_width_layer(cuda, form, seed):
    """One layer at the served widths: qwen (d 1024, I 3072, 16/8 heads of
    128) or gemma (d 768, I 1152, 3/1 heads of 256), int8 with the
    kernels' weight layout."""
    if form == "gemma":
        return _gemma_layer(cuda, seed)
    cfg = EncoderConfig(vocab_size=512, num_layers=1, max_seq_len=128)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    return cfg, params["layers"][0], kernel_layout(quantize_params_int8(params))[0]


@pytest.mark.parametrize("form", ["qwen", "gemma"])
@pytest.mark.parametrize("t", [1, 127, 129, 32768])
def test_mlp_int8_products_bit_equal_plain_stages(cuda, form, t):
    """The int8 product through B4: h (the SwiGLU or GeGLU epilogue) from
    the kernel's own codes, hq from h, and the whole output (the residual
    epilogue, or the bf16 product and the post-norm pass) bit-equal to
    the plain stages, with token tiles ragged and whole."""
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        _act, dequant, i8_matmul, quant_rows_plain,
    )

    cfg, layer, lq = _full_width_layer(cuda, form, t)
    x = torch.randn((t, cfg.hidden_size), generator=torch.Generator(device=cuda).manual_seed(t),
                    device=cuda).to(torch.bfloat16)
    if form == "qwen":
        nw, pw, act = layer["mlp_norm"], None, "silu"
    else:
        nw, pw, act = 1.0 + layer["pre_mlp_norm"], 1.0 + layer["post_mlp_norm"], "gelu_tanh"
    args = (x, nw, lq["w_gate"], lq["w_up"], lq["w_down"], pw)
    stages = {}
    out = fused_mlp_int8_layer(*args, eps=cfg.rms_norm_eps, act=act, stages=stages)
    sx = stages["sx"][:, None]
    gate = dequant(i8_matmul(stages["xq"], lq["w_gate"]["q"]), sx, lq["w_gate"]["s"])
    up = dequant(i8_matmul(stages["xq"], lq["w_up"]["q"]), sx, lq["w_up"]["s"])
    assert torch.equal(stages["h"], (_act(act)(gate) * up).to(torch.bfloat16))
    hq, sh = quant_rows_plain(stages["h"])
    assert torch.equal(stages["hq"], hq) and torch.equal(stages["sh"], sh[:, 0])
    assert torch.equal(out, fused_mlp_int8_layer_plain(*args, eps=cfg.rms_norm_eps, act=act))


@pytest.mark.parametrize("form", ["qwen", "gemma"])
@pytest.mark.parametrize("b,s", [(1, 1), (1, 127), (3, 43), (512, 64)])
def test_attn_int8_products_bit_equal_plain_stages(cuda, form, b, s):
    """The int8 product through B3 at T = 1, 127, 129 and 32,768 tokens:
    q, k, v (the bf16 epilogue) from the kernel's own codes, aq from the
    kernel's attention output, and the block output from aq (the residual
    epilogue, or the bf16 product and the post-norm pass) bit-equal to
    the plain stages."""
    from theoremsearch_tpu_torch.encoder.gemma import _rope_tables as gemma_rope
    from theoremsearch_tpu_torch.kernels.layer_int8 import (
        _block_out, dequant, fused_attn_int8_layer_gemma, i8_matmul, quant_rows_plain,
    )

    cfg, layer, lq = _full_width_layer(cuda, form, s)
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + s)
    x = torch.randn((b, s, cfg.hidden_size), generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
    pos = torch.clamp(mask.cumsum(1) - 1, min=0)
    stages = {}
    if form == "qwen":
        rope = _rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        out = fused_attn_int8_layer(x, layer, lq, mask, rope, cfg, stages=stages)
        pw = None
    else:
        rope = gemma_rope(pos, cfg.head_dim, cfg.rope_local_theta)
        out = fused_attn_int8_layer_gemma(x, layer, lq, mask, rope, cfg, stages=stages)
        pw = 1.0 + layer["post_attn_norm"]
    sx = stages["sx"][:, None]
    for name, key in (("q", "wq"), ("k", "wk"), ("v", "wv")):
        want = dequant(i8_matmul(stages["xq"], lq[key]["q"]), sx, lq[key]["s"])
        assert torch.equal(stages[name], want.to(torch.bfloat16).view(b, s, -1)), name
    aq, sa = quant_rows_plain(stages["ao"].view(b * s, -1))
    assert torch.equal(stages["aq"], aq) and torch.equal(stages["sa"], sa[:, 0])
    y = dequant(i8_matmul(stages["aq"], lq["wo"]["q"]), stages["sa"][:, None], lq["wo"]["s"])
    want = x.view(b * s, -1) + _block_out(y, pw, cfg.rms_norm_eps)
    assert torch.equal(out, want.view(b, s, -1))


# ---- B1 on wgmma + TMA with whole-group skipping, B7 on bf16 tensor cores ----


def _b1_inputs(cuda, n, d, b, seed):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8).to(cuda)
    q8 = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8).to(cuda)
    return g, codes, q8


@pytest.mark.parametrize("b", [1, 8, 64, 127, 129, 1024])
@pytest.mark.parametrize("d,rb,m", [(48, 128, 1), (768, 512, 2), (1024, 4096, 4), (1024, 128, 4),
                                    (768, 4096, 1), (48, 512, 4)])
def test_mips_g_kernel_bit_equal_over_batch_and_geometry(cuda, b, d, rb, m):
    """B1's unmasked form bit-equal to plain over the batch (one query
    tile, a partial one, eight), D with a K tail (48, 768) and the row
    block / merge geometries, with n_valid inside the last group."""
    span = rb * m
    n = span * max(2, 8192 // span)
    _, codes, q8 = _b1_inputs(cuda, n, d, b, b + d + rb + m)
    nv = n - 77
    before = mips_g_launches.n
    ck = mips_g_scan(q8, codes, nv, rb, m)
    assert mips_g_launches.n == before + 1
    assert torch.equal(ck, mips_g_scan_plain(q8, codes, nv, rb, m))


@pytest.mark.parametrize("kind", ["range", "stripe", "three", "none", "random", "first_groups"])
@pytest.mark.parametrize("b,d,rb,m", [(8, 48, 128, 1), (129, 768, 512, 2), (1024, 1024, 4096, 4),
                                      (64, 1024, 128, 4)])
def test_mips_g_mask_form_bit_equal_with_skipped_groups(cuda, kind, b, d, rb, m):
    """The one-mask form, whose kernel skips every 128-row group with no
    passing row: bit-equal to plain for masks that leave no group, a few
    groups, every group, and contiguous id ranges (the year filters)."""
    span = rb * m
    n = span * max(2, 16384 // span)
    g, codes, q8 = _b1_inputs(cuda, n, d, b, 7 * b + d)
    mask = _mask(kind, n, g) if kind != "first_groups" else torch.zeros(n, dtype=torch.int8)
    if kind == "first_groups":
        mask[:300] = 1
    mask = mask.to(cuda)
    before = mips_g_mask_launches.n
    ck = mips_g_scan(q8, codes, n - 5, rb, m, mask=mask)
    assert mips_g_mask_launches.n == before + 1
    assert torch.equal(ck, mips_g_scan_plain(q8, codes, n - 5, rb, m, mask=mask))


@pytest.mark.parametrize("n_masks", [1, 8, 32, 128])
@pytest.mark.parametrize("b", [8, 129, 1024])
def test_mips_g_gmask_form_bit_equal_with_ids_out_of_range(cuda, n_masks, b):
    """The grouped form (batch ordered by mask id, groups skipped per
    query tile) bit-equal to plain, with ids outside [0, G) and masks of
    every kind."""
    n, d, rb, m = 16384, 256, 1024, 2
    g, codes, q8 = _b1_inputs(cuda, n, d, b, 31 * n_masks + b)
    kinds = ["range", "stripe", "three", "none", "random"]
    gm = torch.stack([_mask(kinds[i % 5], n, g) for i in range(n_masks)]).to(cuda)
    ids = torch.randint(-2, n_masks + 2, (b,), generator=g, dtype=torch.int32).to(cuda)
    before = mips_g_gmask_launches.n
    ck = mips_g_scan(q8, codes, n - 3, rb, m, gmasks=gm, mask_ids=ids)
    assert mips_g_gmask_launches.n == before + 1
    assert torch.equal(ck, mips_g_scan_plain(q8, codes, n - 3, rb, m, gmasks=gm, mask_ids=ids))


@pytest.mark.parametrize("form", ["none", "mask", "gmask"])
@pytest.mark.parametrize("b", [8, 129])
@pytest.mark.parametrize("d", [1040, 2048])
def test_mips_g_streamed_query_chunk_bit_equal_with_split_spans(cuda, form, b, d):
    """D > 1024: the query tile no longer stays resident and its chunk
    rides in every ring stage. Every form bit-equal to plain, with each
    span cut into several slices (8 output blocks for the card's SMs)."""
    from theoremsearch_tpu_torch.kernels.mips import mips_g_splits

    n, rb, m = 32768, 2048, 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mips_g_splits(b, n // (rb * m), rb // 128 * m, sms, masked=form != "none") > 1
    g, codes, q8 = _b1_inputs(cuda, n, d, b, d + b)
    kw = {}
    if form == "mask":
        kw = {"mask": _mask("range", n, g).to(cuda)}
    elif form == "gmask":
        kinds = ["range", "stripe", "three", "none", "random"]
        kw = {"gmasks": torch.stack([_mask(k_, n, g) for k_ in kinds]).to(cuda),
              "mask_ids": torch.randint(-1, 7, (b,), generator=g, dtype=torch.int32).to(cuda)}
    nv = n - 300
    ck = mips_g_scan(q8, codes, nv, rb, m, **kw)
    assert torch.equal(ck, mips_g_scan_plain(q8, codes, nv, rb, m, **kw))


def test_mips_g_gmask_empties_groups_for_one_query_tile_only(cuda):
    """Two query tiles after the id order: signature 0 passes only the
    first 200 rows, signature 1 only rows near the end, so each tile
    skips groups the other computes; bit-equal to plain, and every cell
    a tile's signatures exclude reads exactly INT32_MIN + 1."""
    n, d, rb, m, b = 8192, 1024, 512, 1, 256
    g, codes, q8 = _b1_inputs(cuda, n, d, b, 5)
    gm = torch.zeros((2, n), dtype=torch.int8)
    gm[0, :200] = 1
    gm[1, n - 700:] = 1
    gm = gm.to(cuda)
    ids = (torch.arange(b) % 2).to(torch.int32)[torch.randperm(b, generator=g)].to(cuda)
    ck = mips_g_scan(q8, codes, n, rb, m, gmasks=gm, mask_ids=ids)
    assert torch.equal(ck, mips_g_scan_plain(q8, codes, n, rb, m, gmasks=gm, mask_ids=ids))
    lanes = ck.view(b, n // rb, 128)
    assert bool((lanes[ids == 0, 1:] == -(2**31) + 1).all())
    assert bool((lanes[ids == 1, : (n - 700) // rb] == -(2**31) + 1).all())


def _bwd_case(cuda, b, s, h, hk, full, causal, seed):
    gb = torch.Generator(device=cuda).manual_seed(seed)
    dh = 128
    q = (torch.randn((b, s, h * dh), generator=gb, device=cuda) * 0.5).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=gb, device=cuda) * 0.5).to(torch.bfloat16)
    v = (torch.randn((b, s, hk * dh), generator=gb, device=cuda) * 0.5).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn((2, dh), generator=gb, device=cuda)
    if full:
        mask = torch.ones((b, s), dtype=torch.int32, device=cuda)
    else:
        lens = torch.randint(1, s + 1, (b,), generator=gb, device=cuda)
        mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
        mask[:, 0] = 1
        if s > 4:
            mask[-1, 1 : s // 2] = 0                 # interior holes in one item
            mask[1, :2] = 0                          # causal rows 0-1 with no real key
    ang = torch.clamp(mask.cumsum(1) - 1, min=0)[..., None].float() * torch.rand(
        (dh // 2,), generator=gb, device=cuda)
    gr = (torch.randn((b, s, h * dh), generator=gb, device=cuda) * mask[..., None]).to(torch.bfloat16)
    kw = dict(num_heads=h, num_kv_heads=hk, head_dim=dh, eps=1e-6, causal=causal)
    return (q, k, v, w[0].contiguous(), w[1].contiguous(), ang.cos(), ang.sin(), mask, gr), kw


@pytest.mark.parametrize("s", [1, 7, 16, 33, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_kernel_over_s_groups_masks(cuda, s, group, full, causal):
    """B7 against its plain version: dq/dk/dv cosine > 0.9999 and max abs
    <= 2e-2 * max|plain|, dqw/dkw max abs <= 1e-3 * max|plain|, and a
    second launch bit-equal to the first."""
    from theoremsearch_tpu_torch.kernels.attention import (
        fused_qknorm_rope_attention_bwd, fused_qknorm_rope_attention_bwd_plain)

    hk = 2
    args, kw = _bwd_case(cuda, 3, s, hk * group, hk, full, causal, 100 * s + 10 * group + full)
    out = fused_qknorm_rope_attention_bwd(*args, **kw)
    again = fused_qknorm_rope_attention_bwd(*args, **kw)
    ref = fused_qknorm_rope_attention_bwd_plain(*args, scale=128 ** -0.5, **kw)
    for i, (o, o2, r) in enumerate(zip(out, again, ref)):
        assert torch.equal(o, o2) and o.dtype == r.dtype and o.shape == r.shape
        a, c = o.double().flatten(), r.double().flatten()
        err, top = float((a - c).abs().max()), float(c.abs().max())
        if i < 3 and top == 0.0:                     # S = 1: dq = dk = 0 exactly
            assert err == 0.0, i
        elif i < 3:
            assert float(a @ c / (a.norm() * c.norm())) > 0.9999, i
            assert err <= 2e-2 * top, (i, err, top)
        else:
            assert err <= 1e-3 * top, (i, err, top)


# ---------------------------------------------------------------- live updates


def _live_corpus(n=20_000, d=256, seed=5):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n + 300, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb[:n], emb[n:], q


def _live_ops(eng, new, q):
    """add, update, delete, compact, reclaim: the ids after each step."""
    out = []
    ids = eng.add_documents(new[:200], normalize=False)
    out.append(eng.search_vectors(q, k=10)[1])
    eng.update_document(11, new[200])
    eng.delete_documents(list(range(0, 20_000, 97)) + [int(ids[5]), int(ids[7])])
    out.append(eng.search_vectors(q, k=10)[1])
    out.append(eng.search_vectors(q[:8], k=10)[1])
    assert eng.compact() == 199
    out.append(eng.search_vectors(q, k=10)[1])
    eng.add_documents(new[201:260], normalize=False)
    assert eng.compact(reclaim=True) == 59
    out.append(eng.search_vectors(q, k=10)[1])
    return out


@pytest.mark.parametrize("residual", [False, True])
def test_live_ops_on_the_card_equal_the_cpu_port(cuda, residual):
    """The same adds, updates, deletes, compact and reclaim on the card and
    on the CPU give the same ids (the scans are integer-exact, the
    rescores f32 with TF32 off)."""
    emb, new, q = _live_corpus()
    cfg = IndexConfig(dtype="int8", int8_scale="global", residual=residual)
    kw = {} if residual else {"rescore_vectors": emb}
    on_cpu, on_card = (
        _live_ops(SearchEngine(FlatIndex.build(emb, config=cfg, normalize=False, device=dev),
                               device=dev, **kw), new, q)
        for dev in ("cpu", cuda))
    for a, b in zip(on_cpu, on_card):
        np.testing.assert_array_equal(a, b)


def test_compact_device_fold_bit_equal_to_a_fresh_build(cuda):
    """compact()'s fold on the card (old device rows + delta-sized uploads,
    in-place updates, reclaim's device gather) leaves the same device
    arrays as a fresh engine over the folded index."""
    emb, new, q = _live_corpus()
    for residual in (False, True):
        cfg = IndexConfig(dtype="int8", int8_scale="global", residual=residual)
        kw = {} if residual else {"rescore_vectors": emb}
        eng = SearchEngine(FlatIndex.build(emb, config=cfg, normalize=False, device=cuda),
                           device=cuda, **kw)
        ids = eng.add_documents(new[:100], normalize=False)
        eng.update_document(5, new[100])
        eng.delete_documents([7, int(ids[2])])
        for reclaim in (False, True):
            eng.compact(reclaim=reclaim)
            fresh = SearchEngine(eng.index, device=cuda, rescore_vectors=eng.rescore_vectors,
                                 rescore_residual=eng.rescore_residual)
            assert torch.equal(eng.vectors, fresh.vectors)
            for name in ("_rescore_device", "_res_codes_device", "_res_scales_device"):
                a, b = getattr(eng, name), getattr(fresh, name)
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
            eng.add_documents(new[101:110], normalize=False)


def test_mips_g_mask_form_bit_equal_under_scattered_tombstones(cuda):
    """Scattered deletes leave every 128-row group with passing rows: the
    mask form scans everything and must stay bit-equal to plain."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n, d, rb, m = 262_144, 1024, 4096, 4
    x = torch.randn((n, d), generator=g, device=cuda)
    codes, _ = quantize_global_int8(x / x.norm(dim=1, keepdim=True))
    q8, _ = quantize_queries(torch.randn((512, d), generator=g, device=cuda))
    mask = torch.ones(n, dtype=torch.int8, device=cuda)
    mask[torch.randperm(n, generator=g, device=cuda)[:1000]] = 0
    gm = torch.stack([mask, mask * (torch.arange(n, device=cuda) < n // 3).to(torch.int8)])
    ids = torch.randint(0, 2, (512,), generator=g, device=cuda, dtype=torch.int32)
    for kw in ({"mask": mask}, {"gmasks": gm, "mask_ids": ids}):
        got = mips_g_scan(q8, codes, n - 77, rb, m, **kw)
        assert torch.equal(got, mips_g_scan_plain(q8, codes, n - 77, rb, m, **kw))


def test_device_rescore_residual_on_the_card_matches_plain(cuda):
    """The residual rescore on the card (f32, TF32 off) within 1e-5 of the
    same function on the CPU, ids equal where scores are unique."""
    from theoremsearch_tpu_torch.index.quant import quantize_residual_int8
    from theoremsearch_tpu_torch.kernels.mips import device_rescore_residual

    emb, _, q = _live_corpus(n=50_000, d=1024)
    codes, gs = quantize_global_int8(emb)
    rc, rs = quantize_residual_int8(emb, codes, gs)
    cand = torch.from_numpy(np.random.default_rng(0).integers(-1, 50_000, (64, 160)).astype(np.int32))
    torch.backends.cuda.matmul.allow_tf32 = True           # the rescore must turn it off itself
    try:
        sc, ic = device_rescore_residual(torch.from_numpy(q).to(cuda), cand.to(cuda), codes.to(cuda),
                                         gs, rc.to(cuda), rs.to(cuda), 49_990, k=40)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    sp, ip = device_rescore_residual(torch.from_numpy(q), cand, codes, gs, rc, rs, 49_990, k=40)
    sc, ic = sc.cpu(), ic.cpu()
    fin = torch.isfinite(sp)
    assert torch.equal(fin, torch.isfinite(sc))
    assert float((sc[fin] - sp[fin]).abs().max()) <= 1e-5
    gap = (sp[:, 1:] - sp[:, :-1]).abs() <= 1e-5
    near = torch.zeros_like(fin)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert torch.equal(ic[~near], ip[~near])


# ---------------------------------------------------------------- meshes


def _mesh_case(n=65_536, d=256, seed=11):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = [{"paper_id": f"p{i}", "link": f"https://arxiv.org/abs/{i}", "year": 1995 + i % 30,
             "primary_category": ("math.AG", "math.NT", "math.CO")[i % 3], "theorem_name": "Theorem",
             "slogan": "s", "theorem_body": "b"} for i in range(n)]
    return emb, q, rows


def _mesh_runs(eng, q, filters):
    """(label, scores, ids, launches) of the speed, masked, grouped and
    exact-route searches an engine serves, each counted apart."""
    from theoremsearch_tpu_torch.search.filters import SearchFilters

    year, tag = SearchFilters(year_range=(2000, 2010)), SearchFilters(tags=["math.AG"])
    runs = [("plain", {}), ("year", {"filters": year}),
            ("grouped", {"filters": [(year, tag, None, filters)[i % 4] for i in range(len(q))]})]
    out = []
    for label, kw in runs:
        for c in _MESH_COUNTERS.values():
            c.reset()
        s, i = eng.search_vectors(q, k=10, **kw)
        out.append((label, s, i, {n: c.n for n, c in _MESH_COUNTERS.items()}))
    return out


_MESH_COUNTERS = {"b1": mips_g_launches, "b1_mask": mips_g_mask_launches, "b1_gmask": mips_g_gmask_launches,
                  "b5": mips_topk_launches}


@pytest.mark.parametrize("residual", [False, True])
def test_meshed_engine_on_one_card_equals_the_cpu_mesh(cuda, residual):
    """Four shards on one card ([cuda] * 4) against the same engine on a
    mesh of four "cpu" devices (the plain versions): the speed path, the
    masked and grouped forms and, on a per-row index, the exact route
    agree (ids where scores are unique, scores within 1e-5), and each
    batch launches its kernel once a shard."""
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.search.filters import SearchFilters
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from torch_helpers import ids_agree

    emb, q, rows = _mesh_case()
    cfg = IndexConfig(dtype="int8", int8_scale="global", residual=residual)
    kw = {} if residual else {"rescore_vectors": emb}
    got = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(MeshConfig(shard=4), devices=[dev] * 4)
        eng = SearchEngine(FlatIndex.build(emb, config=cfg, normalize=False, device=dev),
                           meta=CorpusMetadata.from_rows(rows), mesh=mesh, **kw)
        assert eng._speed_ok and eng.n_shards == 4
        got[str(dev)] = _mesh_runs(eng, q, SearchFilters(sources=["arXiv"], year_range=(1996, 2020)))
        if not residual:
            xeng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8"), normalize=False,
                                                device=dev),
                                meta=CorpusMetadata.from_rows(rows), mesh=mesh, rescore_vectors=emb)
            for c in _MESH_COUNTERS.values():
                c.reset()
            s, i = xeng.search_vectors(q, k=40)
            got[str(dev)].append(("exact", s, i, {n: c.n for n, c in _MESH_COUNTERS.items()}))
    for (label, sp, ip, _), (_, sk, ik, n) in zip(got["cpu"], got[str(cuda)]):
        ids_agree(sp, ip, sk, ik, where=label)
        want = {"plain": "b1", "year": "b1_mask", "grouped": "b1_gmask", "exact": "b5"}[label]
        assert n[want] == 4, (label, n)


def test_meshed_ivf_on_one_card_equals_plain(cuda):
    """The list-sharded IVF searcher on [cuda] * 4 against the same index
    searched on a mesh of four "cpu" devices: equal ids where scores are
    unique, B6 once a shard."""
    import dataclasses

    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.index.ivf import IVFIndex
    from theoremsearch_tpu_torch.kernels.mips import ivf_scores_launches
    from torch_helpers import ids_agree

    rng = np.random.default_rng(5)
    cents = rng.standard_normal((64, 256)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    pts = cents[rng.integers(0, 64, 32_768)] + 0.05 * rng.standard_normal((32_768, 256)).astype(np.float32)
    q = cents[rng.integers(0, 64, 8)] + 0.05 * rng.standard_normal((8, 256)).astype(np.float32)
    idx = IVFIndex.build(pts, config=IndexConfig(ivf_nlist=64, dtype="int8"), device=cuda)
    cpu_idx = dataclasses.replace(idx, device=torch.device("cpu"), _dev_cache=None, _sharded_cache=None)
    sp, ip = cpu_idx.sharded_searcher(make_mesh(MeshConfig(shard=4), devices=["cpu"] * 4), k=10, nprobe=8)(q)
    n0 = ivf_scores_launches.n
    sk, ik = idx.sharded_searcher(make_mesh(MeshConfig(shard=4), devices=[cuda] * 4), k=10, nprobe=8)(q)
    assert ivf_scores_launches.n - n0 == 4
    ids_agree(sp, ip, sk, ik, where="sharded IVF")


def test_two_cards_launch_each_shard_on_its_own_card(cuda):
    """A mesh over two cards: every kernel launches on its tensors' card
    (the launch guards), so the sharded speed path, its masked form, the
    exact route, the sharded IVF and a data-parallel encode on
    [cuda:0, cuda:1] equal their one-card runs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.index.ivf import IVFIndex
    from theoremsearch_tpu_torch.search.filters import SearchFilters
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata
    from torch_helpers import ids_agree

    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    # a kernel called on cuda:1 while cuda:0 is current
    with torch.cuda.device(c0):
        g = torch.Generator(device=c1).manual_seed(1)
        x = torch.randn((16_384, 256), generator=g, device=c1)
        codes, _ = quantize_global_int8(x / x.norm(dim=1, keepdim=True))
        q8, _ = quantize_queries(torch.randn((64, 256), generator=g, device=c1))
        assert torch.equal(mips_g_scan(q8, codes, 16_000, 512, 1), mips_g_scan_plain(q8, codes, 16_000, 512, 1))
    emb, q, rows = _mesh_case(n=32_768)
    results = {}
    for devs in ([c0, c0], [c0, c1]):
        mesh = make_mesh(MeshConfig(shard=2), devices=devs)
        eng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8", int8_scale="global"),
                                           normalize=False, device=c0),
                           meta=CorpusMetadata.from_rows(rows), mesh=mesh, rescore_vectors=emb)
        xeng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(dtype="int8"), normalize=False, device=c0),
                            mesh=mesh, rescore_vectors=emb)
        ivf = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=32, dtype="int8"), device=c0)
        results[str(devs)] = [eng.search_vectors(q, k=10),
                              eng.search_vectors(q, k=10, filters=SearchFilters(year_range=(2000, 2010))),
                              xeng.search_vectors(q, k=40),
                              ivf.sharded_searcher(mesh, k=10, nprobe=8)(q[:8])]
    for (sa, ia), (sb, ib) in zip(*results.values()):
        ids_agree(sa, ia, sb, ib, where="two cards")
    cfg = EncoderConfig(max_seq_len=128)
    params = init_params(cfg, torch.Generator(device=c0).manual_seed(0), device=c0)
    texts = [f"every group of order {i} is solvable" for i in range(16)]
    for quant in ("none", "int8"):
        one = BatchedEncoder(params, cfg, quant=quant, device=c0).encode(texts)
        two = BatchedEncoder(params, cfg, quant=quant,
                             mesh=make_mesh(MeshConfig(data=2), devices=[c0, c1])).encode(texts)
        assert (one * two).sum(axis=1).min() >= 0.9999


@pytest.mark.parametrize("kv", [2, 1])
def test_tp_attention_launches_b2_and_b7_once_a_shard(cuda, kv):
    """Tensor-parallel forward and backward on [cuda:0] * 2 with sharded
    params: head-local (4/2 heads, each shard its own 2/1) launches B2 and
    B7 once a shard a layer, gathered (4/1 heads) once a layer; pooled
    rows and every logical leaf's gradient equal the same sharded run
    through the kernels' plain versions (fused="plain")."""
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder.model import shard_params
    from theoremsearch_tpu_torch.kernels.attention import attention_bwd_launches
    from theoremsearch_tpu_torch.train.contrastive import logical_grads, piece_leaves

    cfg = EncoderConfig(vocab_size=2048, hidden_size=512, intermediate_size=1024, num_layers=2,
                        num_heads=4, num_kv_heads=kv, head_dim=128, max_seq_len=64,
                        embedding_dim=512)
    mesh = make_mesh(MeshConfig(shard=2), devices=[cuda] * 2)
    params = shard_params(init_params(cfg, torch.Generator(device=cuda).manual_seed(3), device=cuda),
                          mesh)
    g = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(3, cfg.vocab_size, (16, 64), generator=g, device=cuda)
    mask = (torch.arange(64, device=cuda)[None] < torch.randint(8, 65, (16, 1), generator=g,
                                                                 device=cuda)).to(torch.int32)
    pieces = piece_leaves(params)
    out = {}
    for fused in ("on", "plain"):
        for p in pieces:
            p.requires_grad_(True)
        try:
            f0, b0 = attention_launches.n, attention_bwd_launches.n
            pooled = encode_pooled(params, ids, mask, cfg, fused=fused)
            grads = torch.autograd.grad((pooled * pooled.roll(1, 0)).sum(), pieces)
            torch.cuda.synchronize()
            want = 2 * (2 if kv == 2 else 1) if fused == "on" else 0
            assert (attention_launches.n - f0, attention_bwd_launches.n - b0) == (want, want)
        finally:
            for p in pieces:
                p.requires_grad_(False)
        out[fused] = (pooled.detach(), logical_grads(params, list(grads)))
    (pk, gk), (pp, gp) = out["on"], out["plain"]
    assert torch.nn.functional.cosine_similarity(pk, pp).min() >= 0.9999
    for i, (a, b) in enumerate(zip(gk, gp)):
        cos = torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0)
        assert cos >= 0.999, i
