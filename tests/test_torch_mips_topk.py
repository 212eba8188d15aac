"""Port parity: the exact running top-k scan (plain version of kernel B5)
against the JAX reference's `fused_mips_topk` in Pallas interpret mode
and its XLA twin `xla_mips_topk`.

Tie rule: the port gives an equal score to the lower row everywhere; the
reference's order among equal scores, and its choice at a tied k-th slot,
depend on the rest of its batch. So scores are compared whole (int8
bit-equal, bf16/f32 within 1e-5), ids position by position where the
score is unique, and as sets above the k-th score."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.index.quant import quantize_int8 as j_quant
from theoremsearch_tpu.kernels.mips import fused_mips_topk as j_fused
from theoremsearch_tpu.kernels.mips import xla_mips_topk as j_xla
from theoremsearch_tpu_torch.kernels.mips import TOPK_MAX_K, fused_mips_topk, mips_topk, mips_topk_plain

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()

N, D, RB, B = 4096, 64, 512, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[1000:1040] = x[33]          # duplicate rows, as real corpora hold
    x[3000:3005] = x[33]
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = x[33]
    q[1] = -x[33]
    bias = np.where(rng.random(N) < 0.35, -np.inf, 0.0).astype(np.float32)
    bias[1000:1020] = -np.inf
    return x, q, bias


def assert_topk_match(sj, ij, st, it, atol):
    """Scores equal within atol; ids equal where the score is unique in
    the list, and the ids above the k-th score (by more than 2*atol) of
    each side inside the other side's list."""
    sj, ij, st, it = map(np.asarray, (sj, ij, st, it))
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(fin, np.isfinite(st))
    np.testing.assert_allclose(st[fin], sj[fin], rtol=0, atol=atol)
    np.testing.assert_array_equal(it[~fin], -1)
    for r in range(sj.shape[0]):
        for s, i, s_o, i_o in ((st[r], it[r], sj[r], ij[r]), (sj[r], ij[r], st[r], it[r])):
            above = i[s > s[-1] + 2 * atol]
            assert set(above.tolist()) <= set(i_o.tolist()), (r, sorted(set(above) - set(i_o)))
        for c in range(st.shape[1]):
            if np.isfinite(st[r, c]) and (np.abs(st[r] - st[r, c]) <= 2 * atol).sum() == 1 \
                    and st[r, c] > st[r, -1] + 2 * atol:
                assert it[r, c] == ij[r, c], (r, c)


def _corpus(x, kind):
    if kind == "int8":
        codes, scales = j_quant(x)
        return np.asarray(codes), np.asarray(scales)
    if kind == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16)), None
    return x, None


def _torch_corpus(c):
    if c.dtype.name == "bfloat16":
        return torch.from_numpy(c.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(c)


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nv", [N, 4000])
def test_plain_matches_jax_kernel(data, kind, k, with_bias, nv):
    x, q, bias = data
    c, sc = _corpus(x, kind)
    b = bias if with_bias else None
    sj, ij = j_fused(jnp.asarray(q), jnp.asarray(c), None if sc is None else jnp.asarray(sc),
                     nv, None if b is None else jnp.asarray(b), k=k, row_block=RB, interpret=True)
    st, it = fused_mips_topk(torch.from_numpy(q), _torch_corpus(c),
                             None if sc is None else torch.from_numpy(sc), nv,
                             None if b is None else torch.from_numpy(b), k=k, row_block=RB)
    assert st.dtype == torch.float32 and it.dtype == torch.int32 and st.shape == (B, k)
    assert_topk_match(sj, ij, st.numpy(), it.numpy(), atol=0.0 if kind == "int8" else 1e-5)
    if with_bias:
        ok = it.numpy() >= 0
        assert np.isfinite(bias[it.numpy()[ok]]).all()
    assert (it.numpy() < nv).all()


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
def test_plain_matches_xla_twin(data, kind):
    """`xla_mips_topk` multiplies int8 scores as acc * qscale * scale (the
    kernel: acc * scale, then * qscale), so scores agree to an ulp."""
    x, q, bias = data
    c, sc = _corpus(x, kind)
    sj, ij = j_xla(jnp.asarray(q), jnp.asarray(c), None if sc is None else jnp.asarray(sc),
                   4000, jnp.asarray(bias), k=40)
    st, it = fused_mips_topk(torch.from_numpy(q), _torch_corpus(c),
                             None if sc is None else torch.from_numpy(sc), 4000,
                             torch.from_numpy(bias), k=40, row_block=RB)
    assert_topk_match(sj, ij, st.numpy(), it.numpy(), atol=1e-5)


def test_ties_go_to_the_lower_row(data):
    """Query 0 equals row 33 and its 44 duplicates: the k best are the
    duplicates' lowest rows, in row order, with the same score."""
    x, q, _ = data
    c, sc = _corpus(x, "int8")
    s, i = fused_mips_topk(torch.from_numpy(q[:8]), torch.from_numpy(c), torch.from_numpy(sc),
                           k=10, row_block=RB)
    assert i[0].tolist() == [33] + list(range(1000, 1009))
    assert (s[0] == s[0, 0]).all()


def test_filter_keeping_few_rows_and_none(data):
    x, q, _ = data
    c, sc = _corpus(x, "int8")
    bias = np.full(N, -np.inf, np.float32)
    bias[[7, 2000, 4095]] = 0.0
    args = (torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(sc))
    s, i = fused_mips_topk(*args, N, torch.from_numpy(bias), k=10, row_block=RB)
    assert (np.sort(i[:, :3].numpy(), axis=1) == [7, 2000, 4095]).all()
    assert (i[:, 3:] == -1).all() and torch.isneginf(s[:, 3:]).all()
    s, i = fused_mips_topk(*args, N, torch.full((N,), float("-inf")), k=10, row_block=RB)
    assert (i == -1).all() and torch.isneginf(s).all()


def test_k_beyond_rows_pads_and_cap_raises(data):
    x, q, _ = data
    c, sc = _corpus(x[:256], "int8")
    s, i = fused_mips_topk(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(sc), 250,
                           k=300, row_block=128)
    assert (i[:, :250] >= 0).all() and (i[:, 250:] == -1).all()
    with pytest.raises(ValueError, match="1024"):
        fused_mips_topk(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(sc),
                        k=TOPK_MAX_K + 1, row_block=128)
    with pytest.raises(ValueError, match="scales"):
        fused_mips_topk(torch.from_numpy(q), torch.from_numpy(c), k=10, row_block=128)


def test_wrapper_takes_plain_version_on_cpu(data):
    x, q, bias = data
    qt = torch.from_numpy(q).to(torch.bfloat16)
    ct = torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(bias)
    s1, i1 = mips_topk(qt, ct, None, 4000, bt, 17)
    s2, i2 = mips_topk_plain(qt, ct, None, 4000, bt, 17, chunk_rows=1000)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
