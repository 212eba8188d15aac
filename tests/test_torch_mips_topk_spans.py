"""The host side of the B5 kernel's launch (`kernels/mips.py`) and its
selection plan. The CUDA kernel runs only on the card
(`tests/test_torch_cuda.py`); here an emulation that follows the same plan
is held bit-equal to the plain scan, and to the JAX reference:

- the spans (`mips_topk_spans`, `mips_topk_span_groups`) and the list of
  needed groups (`mips_topk_need`, `mips_topk_group_list`);
- per (query tile, span), the span's groups (every n_spans-th of the
  list), two warpgroups taking them in turns, each with its own
  candidate buffers of CB slots a query, one heap a query for both;
- each warpgroup's first group takes, for each query, the exact k-th
  best score of its 128 rows (where the kernel's lanes that hold a query
  lie in one warp: the int8 and bf16 64-query tiles): no later k-th best
  can be below it;
- a cheap pass keeps the elements whose score reaches the larger of the
  heap root's and that bound; then, in a shuffled order, the key test
  against the root and an
  append, or a pending element when the buffer is full, which makes the
  warpgroup offer its buffers to the per-query heaps (k keys, the root
  the smallest) and test again;
- the heaps of every span into one (B, n_spans * k) key matrix, merged by
  `torch.topk`.

What makes skipping and out-of-order arrival exact is the key: a skipped
row could only give (-inf, row), which no empty slot's (-inf, -1) lets in,
and a tie at the threshold is settled by the row, whatever came first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mips_topk import assert_topk_match
from theoremsearch_tpu.index.quant import quantize_int8 as j_quant
from theoremsearch_tpu.kernels.mips import fused_mips_topk as j_fused
from theoremsearch_tpu_torch.kernels.mips import (
    MIPS_TOPK_GROUP,
    _int_dot,
    _pack_keys,
    _unpack_keys,
    mips_topk_group_list,
    mips_topk_need,
    mips_topk_plain,
    mips_topk_query_tile,
    mips_topk_span_groups,
    mips_topk_spans,
    quantize_queries,
)
from theoremsearch_tpu_torch.utils.device import tf32_off

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()

CB = 32                                  # candidate slots a (warpgroup, query)
EMPTY = int(_pack_keys(torch.tensor([[float("-inf")]]), torch.tensor([-1]))[0, 0])


def _scores(qk, corpus, scales, n_valid, bias):
    """The plain scan's f32 scores, (B, n_pad), -inf at or past n_valid."""
    n_pad = corpus.shape[0]
    with tf32_off():
        qf = qk.float()
        s = _int_dot(qf, corpus).float() if corpus.dtype == torch.int8 else qf @ corpus.float().T
    if scales is not None:
        s = s * scales.float()
    if bias is not None:
        s = s + bias.float()
    return torch.where(torch.arange(n_pad) < n_valid, s, float("-inf"))


def emulate(qk, corpus, scales, n_valid, bias, k, sms=132, seed=0):
    """The B5 kernel's plan on CPU tensors: (scores (B, k), rows (B, k))."""
    b = qk.shape[0]
    n_pad = corpus.shape[0]
    n_groups = n_pad // MIPS_TOPK_GROUP
    n_valid = min(int(n_valid), n_pad)
    s_all = _scores(qk, corpus, scales, n_valid, bias)
    if bias is not None:
        glist, count = mips_topk_group_list(mips_topk_need(bias, n_valid))
        glist, count = glist.tolist(), int(count)
    else:
        glist, count = list(range(n_groups)), -(-max(n_valid, 0) // MIPS_TOPK_GROUP)
    nq = mips_topk_query_tile(k)
    n_spans = mips_topk_spans(b, n_groups, k, sms)
    first_bound = nq == 64 and corpus.dtype != torch.float32
    rng = np.random.default_rng(seed)
    part = torch.full((b, n_spans * k), EMPTY, dtype=torch.int64)
    for q0 in range(0, b, nq):
        qs = list(range(q0, min(b, q0 + nq)))
        for span in range(n_spans):
            heaps = {q: [EMPTY] * k for q in qs}
            bufs = [{q: [] for q in qs}, {q: [] for q in qs}]
            bound = [np.full(len(qs), -np.inf, np.float32) for _ in range(2)]

            def drain(wg):
                for q in qs:
                    for key in bufs[wg][q]:
                        if key > min(heaps[q]):
                            heaps[q].remove(min(heaps[q]))
                            heaps[q].append(key)
                    bufs[wg][q] = []

            for gi, pos in enumerate(mips_topk_span_groups(count, n_spans, span)):
                wg = gi % 2
                rows = torch.arange(MIPS_TOPK_GROUP) + glist[pos] * MIPS_TOPK_GROUP
                s = s_all[qs][:, rows]
                keys = _pack_keys(s, rows)
                if gi < 2 and first_bound:          # the group's exact k-th best score
                    bound[wg] = np.sort(s.numpy(), axis=1)[:, -k]
                roots = _unpack_keys(torch.tensor([min(heaps[q]) for q in qs]))[0].numpy()
                floor = np.maximum(roots, bound[wg])
                todo = list(zip(*np.nonzero(s.numpy() >= floor[:, None])))
                while todo:
                    left = []
                    for j in rng.permutation(len(todo)):
                        qi, c = todo[j]
                        q, key = qs[qi], int(keys[qi, c])
                        if key > min(heaps[q]):
                            if len(bufs[wg][q]) < CB:
                                bufs[wg][q].append(key)
                            else:
                                left.append((qi, c))
                    if left:
                        drain(wg)
                    todo = left
            drain(0)
            drain(1)
            for q in qs:
                part[q, span * k:(span + 1) * k] = torch.tensor(heaps[q])
    return _unpack_keys(torch.topk(part, k, dim=1).values)


def _inputs(kind, n, d, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[300:340] = x[7]                    # duplicated rows: exact ties
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = x[7]
    if kind == "int8":
        codes, sc = j_quant(x)
        qk = quantize_queries(torch.from_numpy(q))[0]
        return qk, torch.from_numpy(np.asarray(codes)), torch.from_numpy(np.asarray(sc)), q, x
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    return torch.from_numpy(q).to(dt), torch.from_numpy(x).to(dt), None, q, x


def _bias(form, n, seed):
    rng = np.random.default_rng(seed)
    if form is None:
        return None
    b = np.full(n, -np.inf, np.float32)
    if form == "random":
        b = np.where(rng.random(n) < 0.4, -np.inf, 0.0).astype(np.float32)
    elif form == "window":                # a contiguous 30% of the ids
        b[int(0.4 * n):int(0.7 * n)] = 0.0
    elif form == "three":                 # all but 3 rows excluded
        b[[5, n // 2, n - 70]] = 0.0
    return torch.from_numpy(b)            # "none": every row excluded


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("k,b", [(1, 3), (10, 8), (40, 70), (64, 1), (65, 20), (200, 5)])
@pytest.mark.parametrize("form", [None, "random", "window", "none", "three"])
def test_emulated_plan_bit_equal_plain(kind, k, b, form):
    n, d = 4096, 48
    qk, corpus, scales, _, _ = _inputs(kind, n, d, b, seed=k + b)
    bias = _bias(form, n, seed=k)
    nv = n - 37
    for sms in (132, 8):                  # many short spans, few long ones
        se, ie = emulate(qk, corpus, scales, nv, bias, k, sms=sms, seed=sms)
        sp, ip = mips_topk_plain(qk, corpus, scales, nv, bias, k)
        assert torch.equal(se, sp) and torch.equal(ie, ip), (kind, k, b, form, sms)


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("k", [10, 40, 64])
def test_emulated_plan_with_the_top_rows_in_one_group(kind, k):
    """Query 0's 64 best rows, at distinct scores, fill group 2 (the first
    group of span 2): the first-group bound must be the exact k-th best
    score of the group, or the k-th row is lost."""
    n, d, b = 4096, 48, 8
    rng = np.random.default_rng(k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for j in range(64):                   # cos(q0, x) = 1 / sqrt(1 + (0.02 j)^2), falling
        e = rng.standard_normal(d).astype(np.float32)
        e -= (e @ q[0]) * q[0]
        x[256 + j] = q[0] + 0.02 * j * e / np.linalg.norm(e)
        x[256 + j] /= np.linalg.norm(x[256 + j])
    if kind == "int8":
        codes, sc = j_quant(x)
        qk, corpus, scales = (quantize_queries(torch.from_numpy(q))[0],
                              torch.from_numpy(np.asarray(codes)), torch.from_numpy(np.asarray(sc)))
    else:
        dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
        qk, corpus, scales = torch.from_numpy(q).to(dt), torch.from_numpy(x).to(dt), None
    se, ie = emulate(qk, corpus, scales, n, None, k, sms=132)
    sp, ip = mips_topk_plain(qk, corpus, scales, n, None, k)
    assert torch.equal(se, sp) and torch.equal(ie, ip)
    assert set(ip[0].tolist()) <= set(range(256, 320))


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("k", [10, 40])
def test_emulated_plan_matches_jax_kernel(kind, k):
    """Against the reference's Pallas kernel in interpret mode: scores
    whole (int8 bit-equal), ids where the score is unique."""
    n, d, b = 4096, 64, 12
    qk, corpus, scales, q, x = _inputs(kind, n, d, b, seed=5)
    bias = _bias("random", n, seed=5)
    if kind == "int8":
        c, sc = j_quant(x)
        jc, jsc = jnp.asarray(c), jnp.asarray(sc)
    else:
        jc, jsc = (jnp.asarray(x, jnp.bfloat16) if kind == "bfloat16" else jnp.asarray(x)), None
    sj, ij = j_fused(jnp.asarray(q), jc, jsc, 4000, jnp.asarray(bias.numpy()), k=k, row_block=512,
                     interpret=True)
    se, ie = emulate(qk, corpus, scales, 4000, bias, k, sms=16)
    if kind == "int8":                    # the per-query factor, as fused_mips_topk applies it
        se = se * quantize_queries(torch.from_numpy(q))[1]
    assert_topk_match(sj, ij, se.numpy(), ie.numpy(), atol=0.0 if kind == "int8" else 1e-5)


def test_need_map_groups_all_excluded_and_past_n_valid():
    n = 16 * MIPS_TOPK_GROUP
    bias = torch.full((n,), float("-inf"))
    bias[3 * 128 + 5] = 0.0               # one passing row in group 3
    bias[7 * 128:9 * 128] = 0.0           # groups 7, 8 whole
    bias[12 * 128 + 127] = -1.0           # a finite bias counts as passing
    bias[15 * 128:] = 0.0                 # group 15, past n_valid below
    need = mips_topk_need(bias, n_valid=15 * 128)
    assert need.dtype == torch.bool and need.tolist() == [
        g in (3, 7, 8, 12) for g in range(16)]
    # a group that starts below n_valid stays, even if n_valid cuts it
    assert mips_topk_need(bias, n_valid=15 * 128 + 1).tolist()[15]
    assert not mips_topk_need(torch.zeros(n), n_valid=0).any()
    glist, count = mips_topk_group_list(need)
    assert glist.dtype == torch.int32 and count.dtype == torch.int32 and count.tolist() == [4]
    assert glist[:4].tolist() == [3, 7, 8, 12]
    assert sorted(glist.tolist()) == list(range(16))


@pytest.mark.parametrize("b,k", [(512, 40), (8, 40), (64, 10), (70, 64), (512, 400), (20000, 40),
                                 (1, 1024)])
def test_spans_fill_one_wave_and_partition_groups(b, k):
    n_groups = 8192
    nq = mips_topk_query_tile(k)
    assert nq == (64 if k <= 64 else 16)
    s = mips_topk_spans(b, n_groups, k, sms=132)
    tiles = -(-b // nq)
    assert 1 <= s <= n_groups
    assert s == 1 or tiles * s <= 132 < tiles * (s + 1)
    for count in (0, 1, 5, 2458, n_groups):
        cuts = [list(mips_topk_span_groups(count, s, i)) for i in range(s)]
        assert sorted(p for c in cuts for p in c) == list(range(count))   # a partition
        assert max(map(len, cuts)) - min(map(len, cuts)) <= 1
    assert mips_topk_spans(b, 3, k, sms=132) <= 3
