"""The host side of the B1 kernel's launch (`kernels/mips.py`): the span
split, the grouped form's batch order and the tile-need map that lets the
kernel skip whole 128-row groups. The CUDA kernel runs only on the card
(`tests/test_torch_cuda.py`); here an emulation that follows the same
plan (order the batch, skip the groups the map rules out, cut each span
into slices, take the max of the slices, put the rows back) is held
bit-equal to the plain scan, which is what makes skipping exact."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.kernels.mips import (
    INT32_MIN,
    MIPS_G_QUERY_TILE,
    mips_g_batch_order,
    mips_g_scan_plain,
    mips_g_splits,
    mips_g_tile_need,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n_blocks,g_eff", [
    (1024, 64, 128), (8, 64, 128), (64, 64, 128), (129, 64, 128), (1, 2, 1), (1, 1, 256),
    (300, 5, 4), (128, 700, 8), (1, 3, 64),
])
def test_splits_power_of_two_dividing_span(b, n_blocks, g_eff, masked):
    s = mips_g_splits(b, n_blocks, g_eff, sms=132, masked=masked)
    assert s >= 1 and s & (s - 1) == 0 and g_eff % s == 0 and s <= 64
    assert s == 1 or g_eff // s >= 8              # a slice keeps at least 8 groups
    tiles = -(-b // MIPS_G_QUERY_TILE)
    want = (4 if masked else 2) * 132
    # the fewest slices that reach the wanted blocks, unless the span runs out
    if s > 1:
        assert tiles * n_blocks * (s // 2) < want
    if s < min(g_eff // 8, 64):
        assert tiles * n_blocks * s >= want


def test_splits_of_the_speed_path():
    # B = 1024 on 1M x 1024 (rb 4096, M 4): 8 query tiles x 64 spans fill the card
    assert mips_g_splits(1024, 64, 128, 132) == 1
    assert mips_g_splits(8, 64, 128, 132) == 8
    assert mips_g_splits(64, 64, 128, 132) == 8
    assert mips_g_splits(256, 64, 128, 132) == 4
    # a year range leaves most spans empty: the masked forms cut finer
    assert mips_g_splits(1024, 64, 128, 132, masked=True) == 2
    assert mips_g_splits(8, 64, 128, 132, masked=True) == 16


def test_batch_order_is_stable_by_id():
    ids = torch.tensor([3, 1, 3, 0, 1, -1, 7, 0] * 40, dtype=torch.int32)
    perm = mips_g_batch_order(ids)
    srt = ids[perm]
    assert bool((srt[1:] >= srt[:-1]).all())
    for v in ids.unique():                     # equal ids keep their order
        pos = perm[srt == v]
        assert bool((pos[1:] > pos[:-1]).all())
    assert mips_g_batch_order(ids[:MIPS_G_QUERY_TILE]) is None


def _masks(n, rng):
    m = np.zeros((5, n), np.int8)
    m[0, 1000:1700] = 1          # a contiguous id range
    m[1, 5::22] = 1              # a stripe: every group
    m[2, [3, n - 1]] = 1         # two rows
    m[4] = rng.random(n) < 0.01  # sparse random
    return torch.from_numpy(m)   # m[3]: nothing passes


def test_tile_need_matches_brute_force():
    rng = np.random.default_rng(0)
    n = 8192
    gm = _masks(n, rng)
    for r in range(5):
        need = mips_g_tile_need(n, mask=gm[r])
        want = [int(gm[r, t * 128 : (t + 1) * 128].any()) for t in range(n // 128)]
        assert need.dtype == torch.uint8 and need.tolist() == want
    ids = torch.from_numpy(rng.integers(-1, 7, 300).astype(np.int32))
    need = mips_g_tile_need(n, gmasks=gm, mask_ids=ids)
    assert need.shape == (3, n // 128)
    for qt in range(3):
        tile_ids = ids[qt * 128 : (qt + 1) * 128]
        for t in range(n // 128):
            want = any(0 <= int(i) < 5 and bool(gm[int(i), t * 128 : (t + 1) * 128].any())
                       for i in tile_ids)
            assert need[qt, t] == want


def _emulate(q8, codes, n_valid, rb, m, mask=None, gmasks=None, mask_ids=None, splits=1):
    """The kernel's plan in plain PyTorch: order the batch, walk each
    (query tile, span slice) over the groups the need map keeps, fold
    each group's packed values, combine slices by max, restore rows."""
    b = q8.shape[0]
    n_pad = codes.shape[0]
    g_eff = (rb // 128) * m
    shift = g_eff.bit_length() - 1
    n_blocks = n_pad // (rb * m)
    perm = None
    if gmasks is not None:
        perm = mips_g_batch_order(mask_ids)
        if perm is not None:
            q8, mask_ids = q8[perm], mask_ids[perm]
        need = mips_g_tile_need(n_pad, gmasks=gmasks, mask_ids=mask_ids)
    elif mask is not None:
        need = mips_g_tile_need(n_pad, mask=mask)
    out = torch.full((b, n_blocks * 128), INT32_MIN, dtype=torch.int32)
    per = g_eff // splits
    scores = q8.long() @ codes.long().T
    for qt in range(-(-b // 128)):
        qs = slice(qt * 128, min(b, qt * 128 + 128))
        for blk in range(n_blocks):
            for z in range(splits):
                best = torch.full((qs.stop - qs.start, 128), INT32_MIN, dtype=torch.int64)
                for g in range(z * per, (z + 1) * per):
                    row0 = (blk * g_eff + g) * 128
                    tile = row0 // 128
                    if row0 >= n_valid:
                        continue
                    if mask is not None and not need[tile]:
                        continue
                    if gmasks is not None and not need[qt, tile]:
                        continue
                    rows = torch.arange(row0, row0 + 128)
                    keep = (rows < n_valid).expand(qs.stop - qs.start, 128)
                    if mask is not None:
                        keep = keep & (mask[rows] != 0)
                    if gmasks is not None:
                        ids = mask_ids[qs].long()
                        ok = (ids >= 0) & (ids < gmasks.shape[0])
                        keep = keep & (gmasks[ids.clamp(0, gmasks.shape[0] - 1)][:, rows] != 0) & ok[:, None]
                    packed = (scores[qs, row0 : row0 + 128] << shift) | g
                    best = torch.maximum(best, torch.where(keep, packed, INT32_MIN))
                cols = slice(blk * 128, blk * 128 + 128)
                out[qs, cols] = torch.maximum(out[qs, cols], best.to(torch.int32))
    if perm is not None:
        out = torch.empty_like(out).index_copy_(0, perm, out)
    return out


@pytest.mark.parametrize("form", ["none", "mask", "gmask"])
@pytest.mark.parametrize("splits", [1, 4])
def test_emulated_kernel_plan_bit_equal_plain(form, splits):
    rng = np.random.default_rng(1)
    n, d, rb, m, b = 4096, 32, 256, 2, 300
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
    gm = _masks(n, rng)
    kw = {}
    if form == "mask":
        kw = {"mask": gm[0]}
    elif form == "gmask":
        kw = {"gmasks": gm, "mask_ids": torch.from_numpy(rng.integers(-1, 6, b).astype(np.int32))}
    nv = n - 100
    got = _emulate(q8, codes, nv, rb, m, splits=splits, **kw)
    assert torch.equal(got, mips_g_scan_plain(q8, codes, nv, rb, m, **kw))


def test_skipped_groups_hold_only_the_sentinel():
    """Wherever the need map says 0, every packed value of the group is
    the sentinel: at rb = 128, M = 1 each output block is one group."""
    rng = np.random.default_rng(2)
    n, d, b = 4096, 16, 200
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
    gm = _masks(n, rng)
    ids = torch.from_numpy(rng.integers(-1, 6, b).astype(np.int32))
    out = mips_g_scan_plain(q8, codes, n, 128, 1, gmasks=gm, mask_ids=ids)
    need = mips_g_tile_need(n, gmasks=gm, mask_ids=ids)
    for qt in range(need.shape[0]):
        rows = slice(qt * 128, min(b, qt * 128 + 128))
        for t in torch.nonzero(need[qt] == 0).flatten().tolist():
            assert bool((out[rows, t * 128 : (t + 1) * 128] == INT32_MIN).all())
