"""Port parity: the speed path's scan (plain version of the packed
lane-maxima kernel + exact selection) and device_rescore, against the
JAX reference run as its own tests run it (Pallas interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.index.quant import quantize_global_int8 as j_quant_g
from theoremsearch_tpu.kernels.mips import _quantize_queries as j_quantize_queries
from theoremsearch_tpu.kernels.mips import device_rescore as j_device_rescore
from theoremsearch_tpu.kernels.mips import fused_mips_topk_g as j_fused_g
from theoremsearch_tpu_torch.kernels.mips import (
    INT32_MIN,
    device_rescore,
    fused_mips_topk_g,
    merge_topk,
    mips_g_scan,
    mips_g_scan_plain,
    quantize_queries,
)

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()


def _corpus(n, d, seed, negate=False):
    """Unit rows; with `negate`, every row leans against e_0, which the
    queries lean towards, so every score is negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if negate:
        x = 0.6 * x
        x[:, 0] = -0.8 - np.abs(x[:, 0])
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    codes, scale = j_quant_g(x)
    return rng, x, codes, scale


def _queries(rng, x, b, negate=False):
    q = rng.standard_normal((b, x.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if negate:
        q = 0.3 * q
        q[:, 0] = 1.0
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _numpy_packed(q, codes, n_valid, row_block, merge_tiles):
    """Numpy oracle of the packing: (B, n_blocks*128) int32."""
    q8, _ = j_quantize_queries(jnp.asarray(q))
    s = np.asarray(q8, np.int64) @ np.asarray(codes, np.int64).T       # (B, N)
    b, n = s.shape
    g_eff = (row_block // 128) * merge_tiles
    shift = int(np.log2(g_eff))
    span = row_block * merge_tiles
    nb = n // span
    cells = s.reshape(b, nb, g_eff, 128)
    packed = cells * (1 << shift) + np.arange(g_eff)[None, None, :, None]
    rows = np.arange(n).reshape(nb, g_eff, 128)
    packed = np.where(rows[None] < n_valid, packed, INT32_MIN)
    out = packed.max(axis=2).reshape(b, nb * 128)
    assert out.max() < 2**31 and out.min() >= -(2**31)
    return out.astype(np.int32)


def _assert_same_selection(sj, ij, st, it):
    """Decoded scores equal; (score, id) sets per row equal. The
    reference selects over the f32 cast of the packed values, which
    rounds low bits above 2^24 and may order the last slot's near-ties
    differently: a slot counts as tied when another candidate has the
    same f32 score."""
    sj, ij, st, it = map(np.asarray, (sj, ij, st, it))
    for r in range(sj.shape[0]):
        a = set(zip(sj[r].tolist(), ij[r].tolist()))
        b = set(zip(st[r].tolist(), it[r].tolist()))
        if a != b:
            diff = a ^ b
            edge = min(sj[r].min(), st[r].min())
            assert all(s == edge for s, _ in diff), (r, sorted(diff))
        np.testing.assert_array_equal(np.sort(sj[r]), np.sort(st[r]))


CASES = [
    # n, d, row_block, n_valid, merge_tiles, k, b, negate
    (8192, 128, 512, 8192, 1, 40, 16, False),      # unpadded
    (8192, 128, 512, 8000, 1, 40, 16, False),      # padded
    (8192, 128, 512, 8000, 2, 40, 16, True),       # merge 2, negative scores
    (8192, 128, 512, 7000, 4, 40, 16, True),       # merge 4, negative scores
    (16384, 1024, 4096, 16000, 4, 40, 8, False),   # D=1024 at the packing bound
    (256, 64, 128, 200, 1, 300, 8, False),         # tiny corpus: k > width
]


@pytest.mark.parametrize("n,d,rb,nv,m,k,b,neg", CASES)
def test_plain_fused_g_matches_jax(n, d, rb, nv, m, k, b, neg):
    rng, x, codes, scale = _corpus(n, d, seed=n + d + m, negate=neg)
    q = _queries(rng, x, b, neg)
    sj, ij = j_fused_g(jnp.asarray(q), jnp.asarray(codes), scale, nv, k=k,
                       row_block=rb, merge_tiles=m, interpret=True)
    st, it = fused_mips_topk_g(torch.from_numpy(q), torch.from_numpy(codes), scale, nv,
                               k=k, row_block=rb, merge_tiles=m)
    assert st.dtype == torch.float32 and it.dtype == torch.int32 and st.shape == (b, k)
    _assert_same_selection(sj, ij, st.numpy(), it.numpy())
    valid = it.numpy() >= 0
    assert (it.numpy()[valid] < nv).all()
    if neg:
        assert (st.numpy()[valid] < 0).all()


@pytest.mark.parametrize("n,d,rb,nv,m,k,b,neg", CASES)
def test_plain_candidates_bit_equal_numpy_oracle(n, d, rb, nv, m, k, b, neg):
    rng, x, codes, _ = _corpus(n, d, seed=n + d + m, negate=neg)
    q = _queries(rng, x, b, neg)
    q8, _ = quantize_queries(torch.from_numpy(q))
    cand = mips_g_scan(q8, torch.from_numpy(codes), nv, rb, m)   # CPU -> plain version
    np.testing.assert_array_equal(cand.numpy(), _numpy_packed(q, codes, nv, rb, m))
    np.testing.assert_array_equal(
        mips_g_scan_plain(q8, torch.from_numpy(codes), nv, rb, m).numpy(), cand.numpy())


def test_quantize_queries_bit_equal_with_ties():
    rng = np.random.default_rng(5)
    q = np.concatenate([
        np.array([[127.0, 0.5, 1.5, -2.5, -0.5, 3.5], [0.0] * 6, [-4.0, 1.0, 2.0, 0.5, 0.25, 3.0]],
                 np.float32),
        rng.standard_normal((200, 6)).astype(np.float32)])
    # jitted, as the reference's scan runs it (XLA turns / 127 into a
    # reciprocal multiply there)
    jq8, jqs = jax.jit(j_quantize_queries)(jnp.asarray(q))
    q8, qs = quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))


@pytest.mark.parametrize("n_valid", [None, 900])
def test_device_rescore_matches_jax(n_valid):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1000, 128)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    cand = rng.integers(0, 1000, (8, 40)).astype(np.int32)
    cand[:, -3:] = -1
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    sj, ij = j_device_rescore(jnp.asarray(q), jnp.asarray(cand), xj, n_valid, k=10)
    st, it = device_rescore(torch.from_numpy(q), torch.from_numpy(cand), xb, n_valid, k=10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


def test_merge_topk():
    s = torch.tensor([[0.1, 0.9, 0.5, 0.7]])
    i = torch.tensor([[10, 11, 12, 13]])
    ms, mi = merge_topk(s, i, 2)
    assert mi.tolist() == [[11, 13]]
    np.testing.assert_allclose(ms.numpy(), [[0.9, 0.7]])


def test_packing_overflow_and_bad_shapes_raise():
    codes = torch.zeros((8192, 8192), dtype=torch.int8)[:, :4200]
    with pytest.raises(ValueError, match="packing overflow"):
        fused_mips_topk_g(torch.zeros((8, 4200)), codes.contiguous(), 1.0, k=10, row_block=4096)
    with pytest.raises(ValueError, match="merge_tiles"):
        fused_mips_topk_g(torch.zeros((8, 64)), torch.zeros((1024, 64), dtype=torch.int8), 1.0,
                          k=10, row_block=512, merge_tiles=3)
