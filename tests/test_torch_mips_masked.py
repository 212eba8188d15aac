"""Port parity: the masked and grouped forms of the packed lane-maxima
scan (plain version + exact selection) against the JAX reference's
`fused_mips_topk_g(mask=... / gmasks=...)` in Pallas interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.index.quant import quantize_global_int8 as j_quant_g
from theoremsearch_tpu.kernels.mips import fused_mips_topk_g as j_fused_g
from theoremsearch_tpu_torch.kernels.mips import (
    INT32_MIN,
    fused_mips_topk_g,
    mips_g_scan,
    mips_g_scan_plain,
    quantize_queries,
)

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()

N, D, RB = 8192, 128, 512


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    codes, scale = j_quant_g(x)
    q = rng.standard_normal((16, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return rng, np.asarray(codes), float(scale), q


def _mask(kind: str, rng) -> np.ndarray:
    m = np.zeros(N, np.int8)
    if kind == "range":          # contiguous ids: survivors in adjacent columns
        m[2000:4500] = 1
    elif kind == "stripe":       # one category of 22, striped
        m[5::22] = 1
    elif kind == "three":
        m[[11, 4097, 8000]] = 1
    elif kind == "random":
        m = (rng.random(N) < 0.3).astype(np.int8)
    return m                     # "none": nothing passes


def _both(q, codes, scale, nv, m, k=40, **kw):
    sj, ij = j_fused_g(jnp.asarray(q), jnp.asarray(codes), scale, nv,
                       None if "gmasks" in kw else jnp.asarray(m), k=k, row_block=RB,
                       merge_tiles=kw.get("merge_tiles"), interpret=True,
                       gmasks=None if "gmasks" not in kw else jnp.asarray(kw["gmasks"]),
                       mask_ids=None if "gmasks" not in kw else jnp.asarray(kw["mask_ids"]))
    st, it = fused_mips_topk_g(torch.from_numpy(q), torch.from_numpy(codes), scale, nv,
                               None if "gmasks" in kw else torch.from_numpy(m), k=k,
                               row_block=RB, merge_tiles=kw.get("merge_tiles"),
                               gmasks=None if "gmasks" not in kw else torch.from_numpy(kw["gmasks"]),
                               mask_ids=None if "gmasks" not in kw else torch.from_numpy(kw["mask_ids"]))
    return np.asarray(sj), np.asarray(ij), st.numpy(), it.numpy()


@pytest.mark.parametrize("kind", ["range", "stripe", "three", "none", "random"])
@pytest.mark.parametrize("nv,m", [(N, 1), (8000, 2), (7001, 4)])
def test_masked_scan_bit_equal_jax(data, kind, nv, m):
    rng, codes, scale, q = data
    mask = _mask(kind, rng)
    sj, ij, st, it = _both(q, codes, scale, nv, mask, merge_tiles=m)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(it, ij)
    ok = it >= 0
    assert (mask[it[ok]] == 1).all() and (it[ok] < nv).all()
    n_pass = int(mask[:nv].sum())
    assert (ok.sum(axis=1) == min(40, n_pass)).all() or kind == "random"
    if kind == "none":
        assert (it == -1).all() and np.isneginf(st).all()


@pytest.mark.parametrize("g", [3, 8, 32])
@pytest.mark.parametrize("nv,m", [(8000, 1), (N, 2), (7001, 4)])
def test_grouped_scan_bit_equal_jax(data, g, nv, m):
    rng, codes, scale, q = data
    kinds = ["range", "stripe", "three", "none", "random"]
    gm = np.stack([_mask(kinds[i % 5], rng) for i in range(g)])
    mid = rng.integers(0, g, q.shape[0]).astype(np.int32)
    sj, ij, st, it = _both(q, codes, scale, nv, None, gmasks=gm, mask_ids=mid, merge_tiles=m)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(it, ij)
    for b in range(q.shape[0]):
        ok = it[b] >= 0
        assert (gm[mid[b], it[b][ok]] == 1).all()


def test_grouped_rows_equal_single_mask_scans(data):
    """Query b of a grouped scan sees exactly what a one-mask scan with
    its row gives it, and an id outside [0, G) excludes every row."""
    rng, codes, scale, q = data
    gm = np.stack([_mask(k, rng) for k in ("range", "stripe", "random")])
    mid = np.array([0, 1, 2, 5, -1] * 3 + [1], np.int32)
    q8, _ = quantize_queries(torch.from_numpy(q))
    ct = torch.from_numpy(codes)
    grouped = mips_g_scan(q8, ct, 8000, RB, 2, gmasks=torch.from_numpy(gm),
                          mask_ids=torch.from_numpy(mid))
    for b, r in enumerate(mid):
        if 0 <= r < 3:
            one = mips_g_scan_plain(q8[b : b + 1], ct, 8000, RB, 2, mask=torch.from_numpy(gm[r]))
            np.testing.assert_array_equal(grouped[b].numpy(), one[0].numpy())
        else:
            assert (grouped[b] == INT32_MIN).all()


def test_mask_arguments_validated(data):
    _, codes, scale, q = data
    qt, ct = torch.from_numpy(q), torch.from_numpy(codes)
    gm = torch.ones((2, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="OR"):
        fused_mips_topk_g(qt, ct, scale, mask=torch.ones(N), gmasks=gm,
                          mask_ids=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="mask_ids"):
        fused_mips_topk_g(qt, ct, scale, gmasks=gm)
    with pytest.raises(ValueError, match="128"):
        fused_mips_topk_g(qt, ct, scale, gmasks=torch.ones((129, N), dtype=torch.int8),
                          mask_ids=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="columns"):
        fused_mips_topk_g(qt, ct, scale, mask=torch.ones(N - 1))
    # a bool mask is cast to int8, as the reference casts it
    s_b, i_b = fused_mips_topk_g(qt, ct, scale, mask=torch.arange(N) < 3000, k=10, row_block=RB)
    s_i, i_i = fused_mips_topk_g(qt, ct, scale, mask=(torch.arange(N) < 3000).to(torch.int8),
                                 k=10, row_block=RB)
    assert torch.equal(i_b, i_i) and (i_b < 3000).all()
