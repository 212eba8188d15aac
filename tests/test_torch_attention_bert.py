"""BERT's attention kernel (`kernels/attention_bert.py`, `csrc/attention_bert.cu`)
and the tower's dispatch to it (`encoder/bert.py:_core`).

On the CPU: the plain version against the composition it replaces
(`encoder/bert.py:_attention_core`, the path of fused="off"), the bias adds
it folds in, and the routing by mode, device, shape and grad mode, the
tensor-parallel forward's included. The kernel tests are marked `cuda` and
skip without a card. This file imports no jax, so they also run on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bert.py -q
"""

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core.config import BertEncoderConfig
from theoremsearch_tpu_torch.encoder import bert as B
from theoremsearch_tpu_torch.kernels.attention_bert import (
    attention_bert_launches,
    bert_attention,
    bert_attention_plain,
)

# a two-layer tower whose heads are BERT-base's (64 wide)
SMALL = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
             max_seq_len=512, embedding_dim=128)


def _case(dev, b, s, h, seed, bias=False):
    """q/k/v projections (B, S, H * 64) bf16 and a padding mask: random
    lengths, and where the batch has room one full item, one whose only
    real key is the first (a padded batch row's), one of length 1 past
    the first key tile's start and one ending mid-step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = ((torch.randn((b, s, h * 64), generator=g, device=dev) * sd).to(torch.bfloat16)
               for sd in (2.0, 2.0, 1.0))
    lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).to(torch.int32)
    if b >= 4:
        mask[0] = 1
        mask[1] = 0
        mask[1, 0] = 1
        mask[2] = (torch.arange(s, device=dev) < min(s, 70)).to(torch.int32)
        mask[3] = (torch.arange(s, device=dev) < max(1, s - 13)).to(torch.int32)
    biases = None
    if bias:
        biases = tuple(0.3 * torch.randn((h * 64,), generator=g, device=dev) for _ in range(3))
    return q, k, v, mask, biases


# The share of the bf16 outputs at real query rows that may differ between
# two computations of the same arithmetic, and the largest difference over
# max|ref|. They differ where the bf16 cast of a probability rounds to the
# other neighbour (an exponential or a row sum off by an f32 rounding, an
# f32 sum of P V taken in another order), and each such flip moves p by
# 2^-8 of itself; the plain version read (under 1e-3 against the
# composition on the CPU) and the kernel (on an H100) sit far under these.
# Another rounding of P (bf16 before the division by the row sum, as a
# flash-style single pass takes it) differs in a third or more.
MISMATCH, MAX_ERR = 5e-3, 1e-2


def _same_arithmetic(out, ref, mask):
    real = mask.bool()
    o, r = out[real], ref[real]
    mismatch = float((o != r).float().mean())
    err = float((o.float() - r.float()).abs().max()) / float(r.float().abs().max())
    assert mismatch <= MISMATCH and err <= MAX_ERR, (mismatch, err)


def _padded_rows_zero(out, mask):
    assert torch.isfinite(out.float()).all()
    assert not out[~mask.bool()].any()


# ---- the plain version, on the CPU ----


@pytest.mark.parametrize("s", [64, 128, 256, 512])
def test_plain_matches_the_composition(s):
    q, k, v, mask, _ = _case(torch.device("cpu"), 4, s, 2, seed=s)
    got = bert_attention_plain(q, k, v, mask, num_heads=2)
    ref = B._attention_core(q, k, v, mask.bool(), 2, 64)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _same_arithmetic(got, ref, mask)
    _padded_rows_zero(got, mask)
    # a row that sees only the first key takes that key's value row
    assert torch.equal(got[1, 0], v[1, 0])


@pytest.mark.parametrize("s", [64, 512])
def test_a_flash_style_rounding_is_told_apart(s):
    """P rounded to bf16 before the division by the row sum (one pass over
    the keys, as B2's long form takes it) fails the bound the kernel is
    held to: the bound tells the two roundings apart."""
    b, h = 4, 2
    q, k, v, mask, _ = _case(torch.device("cpu"), b, s, h, seed=7 + s)
    qh, kh, vh = (t.reshape(b, s, h, 64).float() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / 8
    logits = torch.where(mask.bool()[:, None, None, :], logits, -1e30)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(), vh)
    flash = (o / e.sum(dim=-1).transpose(1, 2)[..., None]).to(torch.bfloat16).reshape(b, s, h * 64)
    with pytest.raises(AssertionError):
        _same_arithmetic(flash, bert_attention_plain(q, k, v, mask, num_heads=h), mask)


def test_plain_folds_the_bias_adds_as_the_projection_rounds():
    q, k, v, mask, bias = _case(torch.device("cpu"), 4, 96, 2, seed=3, bias=True)
    got = bert_attention_plain(q, k, v, mask, num_heads=2, bias=bias)
    added = [x + b.to(torch.bfloat16) for x, b in zip((q, k, v), bias)]
    assert torch.equal(got, bert_attention_plain(*added, mask, num_heads=2))
    _same_arithmetic(got, B._attention_core(*added, mask.bool(), 2, 64), mask)


# ---- the dispatch, on the CPU ----


@pytest.mark.parametrize("s", [1, 64, 300, 512, 513])
def test_core_over_mode_shape_dtype_and_grad(s):
    cfg = BertEncoderConfig()
    fits = s <= 512
    with torch.inference_mode():
        assert B._core("on", cfg, s) is (bert_attention if fits else None)
        assert B._core("plain", cfg, s) is (bert_attention_plain if fits else None)
        assert B._core("off", cfg, s) is None
        assert B._core("on", cfg.replace(num_heads=16), s) is None          # head_dim 48
        assert B._core("on", cfg.replace(dtype="float32"), s) is None
        with pytest.raises(ValueError, match="fused"):
            B._core("interpret", cfg, s)
    with torch.no_grad():
        assert B._core("on", cfg, s) is (bert_attention if fits else None)
    with torch.enable_grad():
        assert B._core("on", cfg, s) is None


@pytest.fixture
def calls(monkeypatch):
    """Which form of the core each layer ran: ("kernel" | "plain" |
    "composition", q's width, biases passed)."""
    seen = []

    def wrap(name, fn):
        def f(q, k, v, mask, *args, **kw):
            seen.append((name, q.shape[-1], kw.get("bias") is not None))
            return fn(q, k, v, mask, *args, **kw)
        return f

    monkeypatch.setattr(B, "bert_attention", wrap("kernel", B.bert_attention))
    monkeypatch.setattr(B, "bert_attention_plain", wrap("plain", B.bert_attention_plain))
    monkeypatch.setattr(B, "_attention_core", wrap("composition", B._attention_core))
    return seen


def _tower(s, b=3, seed=0):
    cfg = BertEncoderConfig(**SMALL)
    g = torch.Generator().manual_seed(seed)
    params = B.init_params(cfg, g, device="cpu")
    for layer in params["layers"]:     # biases off zero, so the fold shows
        for name in ("bq", "bk", "bv", "bo", "b_in", "b_out"):
            layer[name] = 0.1 * torch.randn(layer[name].shape, generator=g)
    ids = torch.randint(3, cfg.vocab_size, (b, s), generator=g)
    lens = torch.tensor([s, s // 2 + 5, 1][:b])
    mask = (torch.arange(s)[None] < lens[:, None]).to(torch.int32)
    return cfg, params, ids * mask, mask


def _cos_min(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def test_forward_routes_by_mode_and_grad(calls):
    cfg, params, ids, mask = _tower(256)
    n = cfg.num_layers
    with torch.inference_mode():
        on = B.encode_pooled(params, ids, mask, cfg)      # CPU tensors: the plain version
        assert calls == [("kernel", 128, True)] * n
        calls.clear()
        plain = B.encode_pooled(params, ids, mask, cfg, fused="plain")
        assert calls == [("plain", 128, True)] * n
        calls.clear()
        off = B.encode_pooled(params, ids, mask, cfg, fused="off")
        assert calls == [("composition", 128, False)] * n
        calls.clear()
        B.encode_pooled(params, ids[:, :37], mask[:, :37], cfg)   # any width up to 512
        assert calls == [("kernel", 128, True)] * n
        calls.clear()
    with torch.enable_grad():
        B.encode_pooled(params, ids, mask, cfg)
    assert calls == [("composition", 128, False)] * n     # training keeps the composition
    assert torch.equal(on, plain)
    assert _cos_min(on, off) > 0.9999


def test_forward_on_matches_the_composition_at_real_rows():
    cfg, params, ids, mask = _tower(128, seed=1)
    with torch.inference_mode():
        on = B.forward(params, ids, mask, cfg)
        off = B.forward(params, ids, mask, cfg, fused="off")
    real = mask.bool()
    assert torch.isfinite(on.float()).all()
    assert _cos_min(on[real].float(), off[real].float()) > 0.9999


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask, bias = _case(torch.device("cpu"), 4, 200, 2, seed=5, bias=True)
    n0 = attention_bert_launches.n
    assert torch.equal(bert_attention(q, k, v, mask, num_heads=2, bias=bias),
                       bert_attention_plain(q, k, v, mask, num_heads=2, bias=bias))
    assert attention_bert_launches.n == n0
    with pytest.raises(ValueError, match="device"):
        bert_attention(*(t.to("meta") for t in (q, k, v, mask)), num_heads=2)


def test_tp_forward_takes_the_core_on_each_shard(calls):
    from torch_helpers import cpu_mesh

    cfg, params, ids, mask = _tower(256, b=2, seed=2)
    sharded = B.shard_params(params, cpu_mesh(2))
    with torch.inference_mode():
        got = B.encode_pooled(sharded, ids, mask, cfg)
        # 2 heads over 2 shards: the core once a shard a layer, on its one
        # head, each shard's q/k/v bias blocks added inside it
        assert calls == [("kernel", 64, True)] * (2 * cfg.num_layers)
        one = B.encode_pooled(params, ids, mask, cfg)
    assert _cos_min(got, one) > 0.9999
    calls.clear()
    with torch.enable_grad():
        B.encode_pooled(sharded, ids, mask, cfg)
    assert {c[0] for c in calls} == {"composition"}


# ---- the kernel, on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _check_kernel(q, k, v, mask, h, bias):
    """One launch against the plain version (`_same_arithmetic`), padded
    query rows zero, one launch counted, a second launch bit-equal."""
    n0 = attention_bert_launches.n
    out = bert_attention(q, k, v, mask, num_heads=h, bias=bias)
    assert attention_bert_launches.n == n0 + 1
    assert torch.equal(out, bert_attention(q, k, v, mask, num_heads=h, bias=bias))
    _same_arithmetic(out, bert_attention_plain(q, k, v, mask, num_heads=h, bias=bias), mask)
    _padded_rows_zero(out, mask)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("h", [12, 6])
@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("s", [64, 128, 256, 512])
def test_kernel_matches_plain(cuda, s, b, h):
    q, k, v, mask, bias = _case(cuda, b, s, h, seed=100 * s + b + h, bias=h == 12)
    _check_kernel(q, k, v, mask, h, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 37, 100, 300, 449])
def test_kernel_at_partial_tiles(cuda, s):
    """Widths whose last key tile, step or query block is partial, and the
    TP forward's one-head shard."""
    for h in (1, 12):
        q, k, v, mask, bias = _case(cuda, 5, s, h, seed=s + h, bias=True)
        _check_kernel(q, k, v, mask, h, bias)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask, _ = _case(cuda, 2, 513, 2, seed=0)
    with pytest.raises(ValueError):
        bert_attention(q, k, v, mask, num_heads=2)
    q, k, v, mask, _ = _case(cuda, 2, 64, 2, seed=0)
    with pytest.raises(ValueError):
        bert_attention(q, k, v, mask, num_heads=4)         # heads of 32
    with pytest.raises(ValueError):
        bert_attention(q.float(), k.float(), v.float(), mask, num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [2, 8])
def test_tp_forward_takes_the_kernel_with_each_shards_biases(cuda, shard):
    """BERT-base's heads (12 of 64) over a tp mesh of `shard` shards on one
    card: head-local at 2 (six heads a shard: the kernel once a shard a
    layer, on its bias blocks), gathered at 8 (once a layer, on the whole
    biases); the pooled rows against the one-device forward's."""
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    cfg = BertEncoderConfig(vocab_size=1024, num_layers=2)
    params = B.init_params(cfg, torch.Generator(device=cuda).manual_seed(4), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            layer[name] = 0.1 * torch.randn(layer[name].shape, generator=g, device=cuda)
    sharded = B.shard_params(params, make_mesh(MeshConfig(shard=shard), devices=[cuda] * shard))
    lens = torch.tensor([256, 200, 37, 1], device=cuda)
    mask = (torch.arange(256, device=cuda)[None] < lens[:, None]).to(torch.int32)
    ids = torch.randint(3, cfg.vocab_size, (4, 256), generator=g, device=cuda) * mask
    with torch.inference_mode():
        before = attention_bert_launches.n
        got = B.encode_pooled(sharded, ids, mask, cfg)
        launches = attention_bert_launches.n - before
        one = B.encode_pooled(params, ids, mask, cfg)
    assert launches == cfg.num_layers * (shard if cfg.num_heads % shard == 0 else 1)
    assert _cos_min(got, one) > 0.9999


@pytest.mark.cuda
def test_batched_encoder_takes_the_kernel_once_a_layer(cuda):
    """BERT-base through `BatchedEncoder` on texts landing in each width
    bucket: the kernel 12 times a sub-batch under inference, 0 times with a
    gradient recorded, and the pooled rows against the float32 composition
    (TF32 off) within the embed cell's limit on 1 - cos (1.05e-4)."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    cfg = BertEncoderConfig()
    params = B.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv", "bo"):
            layer[name] = 0.1 * torch.randn(layer[name].shape, generator=g, device=cuda)
    be = BatchedEncoder(params, cfg, device=cuda)
    rng = np.random.default_rng(2)
    words = ["".join(chr(97 + i // 26 ** j % 26) for j in range(3)) for i in range(5000)]
    spans = ((20, 60), (70, 120), (130, 250), (260, 500))
    parts = [[" ".join(rng.choice(words, n)) for n in rng.integers(lo, hi, 20)] for lo, hi in spans]
    before = attention_bert_launches.n
    # one call a bucket: a call sorts its texts by length into sub-batches
    got = torch.from_numpy(np.concatenate([be.encode(p) for p in parts])).to(cuda)
    shapes = be.stats()["by_shape"]
    assert shapes == {(32, 64): 1, (32, 128): 1, (32, 256): 1, (32, 512): 1}, shapes
    assert attention_bert_launches.n - before == cfg.num_layers * sum(shapes.values())

    p32 = {n: t.float() for n, t in params.items() if n != "layers"}
    p32["layers"] = [{n: t.float() for n, t in layer.items()} for layer in params["layers"]]
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    want = []
    with torch.inference_mode():
        for width, part in zip((64, 128, 256, 512), parts):
            enc = be.tokenizer(part, max_length=width, pad_to=width)
            ids, mask = (torch.from_numpy(a).to(cuda) for a in (enc.input_ids, enc.attention_mask))
            want.append(B.encode_pooled(p32, ids, mask, cfg32))
    gap = 1 - _cos_min(got, torch.cat(want))
    assert gap <= 1.05e-4, gap

    before = attention_bert_launches.n
    with torch.enable_grad():
        B.encode_pooled(params, ids, mask, cfg)
    assert attention_bert_launches.n == before
