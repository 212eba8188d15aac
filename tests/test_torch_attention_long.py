"""Kernel B2's long form (the qwen form at 128 < S <= 512) and the encoder's
dispatch to it.

The dispatch tests run on the CPU: `_long_core_ok` against shape, head_dim
and grad mode, and the forwards (plain, int8 op-chain, tensor parallel)
taking the fused core at S = 256 only where the predicate holds; on CPU
tensors the core is the long form's plain version. The kernel tests are
marked `cuda` and skip without a card. This file imports no jax, so they
also run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_long.py -q
"""

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder import model as M
from theoremsearch_tpu_torch.kernels.attention import (
    attention_launches,
    attention_long_launches,
    fused_qknorm_rope_attention,
    fused_qknorm_rope_attention_long_plain,
    fused_qknorm_rope_attention_plain,
    plain_version,
)

SMALL = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, max_seq_len=512, embedding_dim=256)


# ---- the dispatch, on the CPU ----


@pytest.mark.parametrize("s", [1, 64, 128, 129, 256, 300, 512, 513, 1024])
def test_long_core_ok_over_shape_device_and_grad(s):
    cfg = EncoderConfig()
    want = 128 < s <= 512
    with torch.inference_mode():
        assert M._long_core_ok(cfg, s) is want
        assert not M._long_core_ok(cfg.replace(head_dim=64), s)
        assert not M._long_core_ok(cfg.replace(num_heads=6, num_kv_heads=4), s)
    with torch.no_grad():
        assert M._long_core_ok(cfg, s) is want
    with torch.enable_grad():
        assert not M._long_core_ok(cfg, s)
    # the reference's rules stay as they were: S <= 128 only
    assert M._fused_ok(cfg, s, 512) is (s <= 128)
    assert M._fused_layer_ok(cfg, s, 512) is (s <= 128)


@pytest.fixture
def core_calls(monkeypatch):
    """The q shapes of the fused core's calls (on CPU tensors it runs each
    form's plain version)."""
    real_apply = M.QKNormRopeAttention.apply
    calls = []

    def apply(*args):
        calls.append(args[0].shape)
        return real_apply(*args)

    monkeypatch.setattr(M.QKNormRopeAttention, "apply", apply)
    return calls


def _inputs(cfg, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, g, device="cpu")
    for layer in params["layers"]:
        for name in ("q_norm", "k_norm"):
            layer[name] = 1 + 0.1 * torch.randn(layer[name].shape, generator=g)
    ids = torch.randint(3, cfg.vocab_size, (b, s), generator=g)
    lens = torch.tensor([s, s // 2 + 7, 200, 1][:b])
    mask = (torch.arange(s)[None] < lens[:, None]).to(torch.int32)
    return params, ids * mask, mask


def _cos_min(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def test_forward_takes_the_long_core_only_without_grad(core_calls):
    cfg = EncoderConfig(**SMALL)
    params, ids, mask = _inputs(cfg, 4, 256)
    with torch.enable_grad():
        M.encode_pooled(params, ids, mask, cfg)
    assert core_calls == []     # training keeps the reference composition
    with torch.inference_mode():
        got = M.encode_pooled(params, ids, mask, cfg)
        assert len(core_calls) == cfg.num_layers
        assert all(shape == (4, 256, cfg.num_heads * cfg.head_dim) for shape in core_calls)
        ref = M.encode_pooled(params, ids, mask, cfg, fused="off")
        assert len(core_calls) == cfg.num_layers
        # the kernel's casts against the reference composition's, in bf16
        assert _cos_min(got, ref) > 0.999
        M.encode_pooled(params, ids[:, :128], mask[:, :128], cfg)   # B2's S <= 128 form
        assert len(core_calls) == 2 * cfg.num_layers


def test_int8_forward_takes_the_long_core(core_calls):
    cfg = EncoderConfig(**SMALL)
    params, ids, mask = _inputs(cfg, 3, 300, seed=1)
    ql = M.quantize_params_int8(params)
    with torch.inference_mode():
        got = M.encode_pooled(params, ids, mask, cfg, qlayers=ql, fused_layers=True)
        assert len(core_calls) == cfg.num_layers
        ref = M.encode_pooled(params, ids, mask, cfg, qlayers=ql, fused="off")
    assert _cos_min(got, ref) > 0.999


def test_tp_forward_takes_the_long_core_on_each_shard(core_calls):
    from torch_helpers import cpu_mesh

    cfg = EncoderConfig(**SMALL)
    params, ids, mask = _inputs(cfg, 2, 256, seed=2)
    sharded = M.shard_params(params, cpu_mesh(2))
    with torch.inference_mode():
        got = M.encode_pooled(sharded, ids, mask, cfg)
        # 2 kv heads over 2 shards: the core once a shard a layer, on its heads
        assert len(core_calls) == 2 * cfg.num_layers
        assert all(shape[-1] == cfg.num_heads // 2 * cfg.head_dim for shape in core_calls)
        one = M.encode_pooled(params, ids, mask, cfg)
    assert _cos_min(got, one) > 0.9999
    core_calls.clear()
    with torch.enable_grad():
        M.encode_pooled(sharded, ids, mask, cfg)
    assert core_calls == []


# ---- the long form's plain version, on the CPU ----


def _agree(out, ref):
    """cosine > 0.9999 and max abs <= 2e-2 * max|ref|: the bound the S <=
    128 form is held to against its plain version, here between two
    roundings of P. Two computations of these casts differ where the bf16
    cast of a probability rounds to the other neighbour (p rounded before
    the division by the row sum rather than after, or an f32 sum taken in
    another order); each such flip moves p by 2^-8 of itself."""
    o, r = out.double().flatten(), ref.double().flatten()
    assert float(o @ r / (o.norm() * r.norm())) > 0.9999
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())


# The share of the long form's bf16 outputs that may differ from its plain
# version's, and the largest difference over max|ref|. The same arithmetic
# in another order (the tensor cores' sums, the kernel's row sums) differs
# by rare one-step flips of a bf16 cast: the kernel read at most 1.13e-3
# and 2.5e-3 over this file's cases on an H100. Other arithmetic shows in
# a third or more of the elements: the softmax over the whole key range
# (P rounded after the division) read 0.33-0.48 against the kernel, and the
# running softmax in 64-key steps 0.047-0.16 against the 32-key one.
LONG_MISMATCH, LONG_MAX_ERR = 5e-3, 1e-2


def _same_arithmetic(out, ref):
    mismatch = float((out != ref).float().mean())
    err = float((out.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
    assert mismatch <= LONG_MISMATCH and err <= LONG_MAX_ERR, (mismatch, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [129, 256, 300])
def test_long_plain_agrees_with_the_whole_range_softmax(s, causal):
    """The running softmax (bf16 of p before the division) against the S <=
    128 forms' softmax over the whole key range (bf16 after it), on ragged
    masks with an item with no real token and one whose only real token
    is in the middle."""
    args = _attn_case(torch.device("cpu"), 4, s, 4, 2, seed=s)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=128, eps=1e-6, causal=causal, scale=128 ** -0.5)
    long, whole = (fused_qknorm_rope_attention_long_plain(*args, **kw),
                   fused_qknorm_rope_attention_plain(*args, **kw))
    _agree(long, whole)
    # the two roundings of P are told apart by the bound the kernel is held
    # to against its own plain version
    assert float((long != whole).float().mean()) > 10 * LONG_MISMATCH


def test_cpu_tensors_take_each_forms_plain_version():
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=128, eps=1e-6, causal=True)
    for s, plain in ((128, fused_qknorm_rope_attention_plain),
                     (200, fused_qknorm_rope_attention_long_plain)):
        assert plain_version(s, 128) is plain
        args = _attn_case(torch.device("cpu"), 2, s, 4, 2, seed=s)
        assert torch.equal(fused_qknorm_rope_attention(*args, **kw),
                           plain(*args, scale=128 ** -0.5, **kw))
    assert plain_version(200, 256) is fused_qknorm_rope_attention_plain


# ---- the kernel, on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _attn_case(dev, b, s, h, hk, seed):
    """Raw q/k/v projections, norm weights off 1, RoPE tables from the
    mask's positions and a ragged mask: random lengths, and where the
    batch has room one full item, one with no real token, one whose only
    real token is in the middle (its earlier causal rows see no real key)
    and one with interior holes."""
    dh = 128
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, s, h * dh), generator=g, device=dev) * 2).to(torch.bfloat16)
    k = (torch.randn((b, s, hk * dh), generator=g, device=dev) * 2).to(torch.bfloat16)
    v = torch.randn((b, s, hk * dh), generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((2, dh), generator=g, device=dev)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).to(torch.int32)
    if b >= 4:
        mask[0] = 1
        mask[1] = 0
        mask[2] = 0
        mask[2, s // 2] = 1
        mask[3, 5::3] = 0
    pos = torch.clamp(mask.cumsum(1) - 1, min=0)
    ang = pos[..., None].float() * torch.rand((dh // 2,), generator=g, device=dev)
    return (q, k, v, w[0], w[1], ang.cos(), ang.sin(), mask)


def _check_long(args, **kw):
    """One launch of the long form against its plain version (the same
    arithmetic: `_same_arithmetic`) and against the S <= 128 forms' plain
    version (`_agree`), one launch counted, and a second launch bit-equal
    to the first (no atomics)."""
    before = (attention_launches.n, attention_long_launches.n)
    out = fused_qknorm_rope_attention(*args, **kw)
    assert (attention_launches.n, attention_long_launches.n) == (before[0], before[1] + 1)
    again = fused_qknorm_rope_attention(*args, **kw)
    assert torch.equal(out, again)
    _same_arithmetic(out, fused_qknorm_rope_attention_long_plain(*args, scale=128 ** -0.5, **kw))
    _agree(out, fused_qknorm_rope_attention_plain(*args, scale=128 ** -0.5, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("s", [129, 256, 300, 512])
def test_long_form_matches_plain(cuda, s, b):
    args = _attn_case(cuda, b, s, 16, 8, seed=10 * s + b)
    _check_long(args, num_heads=16, num_kv_heads=8, head_dim=128, eps=1e-6, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_long_form_over_groups(cuda, group, causal):
    """H/Hk from 1 to 4 (3: a block's 8 strips straddle query rows), the
    bidirectional mask too, at an S whose last key tile and last strip are
    partial."""
    hk = 2
    args = _attn_case(cuda, 5, 300, hk * group, hk, seed=group + 10 * causal)
    _check_long(args, num_heads=hk * group, num_kv_heads=hk, head_dim=128, eps=1e-6,
                causal=causal)


@pytest.mark.cuda
def test_long_form_refuses_what_it_does_not_take(cuda):
    for s, h, hk in ((513, 16, 8), (256, 12, 8)):
        args = _attn_case(cuda, 2, s, h, hk, seed=s)
        with pytest.raises(ValueError):
            fused_qknorm_rope_attention(*args, num_heads=h, num_kv_heads=hk, head_dim=128)


@pytest.mark.cuda
def test_batched_encoder_long_buckets_take_the_long_form(cuda):
    """The full-width qwen tower through `BatchedEncoder` on texts that
    land in the 256- and 512-wide buckets: B2's long form once a layer a
    sub-batch of those widths, and the pooled rows against the float32
    forward (the reference composition, TF32 off) within the embed
    cells' limit on 1 - cos (7e-4)."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    cfg = EncoderConfig()
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for layer in params["layers"]:
        for name in ("q_norm", "k_norm", "attn_norm", "mlp_norm"):
            layer[name] = 1 + 0.1 * torch.randn(layer[name].shape, generator=g, device=cuda)
    be = BatchedEncoder(params, cfg, device=cuda)
    rng = np.random.default_rng(2)
    words = ["".join(chr(97 + i // 26 ** j % 26) for j in range(3)) for i in range(5000)]
    texts = [" ".join(rng.choice(words, n)) for n in
             list(rng.integers(140, 250, 40)) + list(rng.integers(260, 500, 40))]
    before = attention_long_launches.n
    # one call a bucket: a call sorts its texts by length into sub-batches
    got = torch.from_numpy(np.concatenate([be.encode(texts[:40]), be.encode(texts[40:])])).to(cuda)
    shapes = be.stats()["by_shape"]
    assert shapes == {(64, 256): 1, (64, 512): 1}
    assert attention_long_launches.n - before == cfg.num_layers * sum(shapes.values())

    p32 = {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
           "layers": [{n: t.float() for n, t in layer.items()} for layer in params["layers"]]}
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    want = []
    with torch.inference_mode():
        for width, part in ((256, texts[:40]), (512, texts[40:])):
            enc = be.tokenizer(part, max_length=width, pad_to=width)
            ids, mask = (torch.from_numpy(a).to(cuda) for a in (enc.input_ids, enc.attention_mask))
            want.append(M.encode_pooled(p32, ids, mask, cfg32, fused="off"))
    gap = 1 - _cos_min(got, torch.cat(want))
    assert gap <= 7e-4, gap
