"""Port parity: the IVF probe-major chunk scan (plain version of kernel
B6), the fixed-size batch dedupe and the residual int8 codes against the
JAX reference (Pallas in interpret mode). All three are integer or
elementwise work, so they must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.index.quant import quantize_global_int8 as j_quant_g
from theoremsearch_tpu.index.quant import quantize_residual_int8 as j_resid
from theoremsearch_tpu.kernels.mips import ivf_probe_scores as j_ivf_scores
from theoremsearch_tpu_torch.index.ivf import unique_fixed
from theoremsearch_tpu_torch.index.quant import (
    dequantize_residual_int8,
    quantize_global_int8,
    quantize_residual_int8,
)
from theoremsearch_tpu_torch.kernels.mips import ivf_probe_scores, ivf_probe_scores_plain, ivf_scores_launches

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()


def _case(b, c, r, d, uids, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] *= 0.0                                  # a zero (padding) query
    slabs = rng.integers(-127, 128, (c, r, d)).astype(np.int8)
    slabs[-1] = 0                                # the empty fill chunk
    slabs[0, r // 2 :] = 0                       # padding rows inside a chunk
    return q, slabs, np.asarray(uids, np.int32)


CASES = {
    # (B, C, R, D, uids): repeats of the empty chunk, an odd batch, R = 512
    "b8_fills": (8, 7, 128, 128, [0, 2, 3, 6, 6, 6]),
    "b13_odd": (13, 5, 128, 96, [1, 2, 4, 4]),
    "b3_r256": (3, 4, 256, 128, [0, 1, 2, 3, 3]),
    "b5_r512": (5, 4, 512, 64, [3, 0, 2]),
    "b16_one": (16, 3, 128, 128, [1]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bit_equal_to_reference(name):
    b, c, r, d, uids = CASES[name]
    q, slabs, u = _case(b, c, r, d, uids, seed=len(name))
    jc, jq = j_ivf_scores(jnp.asarray(q), jnp.asarray(slabs), jnp.asarray(u), interpret=True)
    tc, tq = ivf_probe_scores_plain(torch.from_numpy(q), torch.from_numpy(slabs), torch.from_numpy(u))
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (b, len(uids) * r)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_wrapper_takes_the_plain_version_on_cpu_without_launching():
    q, slabs, u = _case(8, 7, 128, 128, [0, 2, 6], seed=1)
    before = ivf_scores_launches.n
    tc, tq = ivf_probe_scores(torch.from_numpy(q), torch.from_numpy(slabs), torch.from_numpy(u))
    pc, pq = ivf_probe_scores_plain(torch.from_numpy(q), torch.from_numpy(slabs), torch.from_numpy(u))
    assert torch.equal(tc, pc) and torch.equal(tq, pq)
    assert ivf_scores_launches.n == before


def test_slab_rows_must_be_a_multiple_of_128():
    q, slabs, u = _case(4, 3, 128, 64, [0, 1], seed=2)
    bad = torch.from_numpy(np.ascontiguousarray(slabs[:, :96]))
    with pytest.raises(ValueError, match="multiple of 128"):
        ivf_probe_scores(torch.from_numpy(q), bad, torch.from_numpy(u))
    with pytest.raises(ValueError, match="multiple of 128"):
        j_ivf_scores(jnp.asarray(q), jnp.asarray(slabs[:, :96]), jnp.asarray(u), interpret=True)


@pytest.mark.parametrize("n,size,hi,dups", [
    (30, 25, 20, True),      # duplicates, fewer uniques than size: fills
    (40, 12, 100, False),    # more uniques than size: truncated
    (16, 16, 16, False),     # all distinct, exactly size
    (64, 40, 8, True),       # few values, many repeats
])
def test_unique_fixed_matches_jnp_unique(n, size, hi, dups):
    rng = np.random.default_rng(n + size)
    for trial in range(6):
        flat = (rng.integers(0, hi, n) if dups else rng.permutation(hi)[:n]).astype(np.int64)
        if trial % 2:
            flat[rng.integers(0, n)] = hi          # the fill value itself, once
        want = np.asarray(jnp.unique(jnp.asarray(flat), size=size, fill_value=hi))
        got = unique_fixed(torch.from_numpy(flat), size, hi).numpy()
        np.testing.assert_array_equal(got, want)


def test_residual_int8_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[5] = 0.0                                     # an all-zero residual row
    jcodes, jg = j_quant_g(x)
    codes, g = quantize_global_int8(x)
    assert g == jg
    jrc, jrs = j_resid(x, jcodes, jg, chunk=256)
    rc, rs = quantize_residual_int8(x, codes, g, chunk=256)
    np.testing.assert_array_equal(rc.numpy(), jrc)
    np.testing.assert_array_equal(rs.numpy(), jrs)
    # the two-level reconstruction: ~15 effective bits
    recon = dequantize_residual_int8(codes, g, rc, rs).numpy()
    assert np.abs(recon - x).max() < jg / 100
