"""The scans: the speed path's packed lane maxima over a global-scale int8
corpus (unmasked, masked and grouped-mask forms), the exact running
top-k over any corpus, the IVF probe-major chunk scan, exact selection
and the bf16 rescore.

Port of theoremsearch_tpu/kernels/mips.py. Three TPU kernels become
hand-written CUDA kernels:

- `_mips_g_kernel` -> `csrc/mips_g.cu`, reached through `mips_g_scan`
  (plain version `mips_g_scan_plain`);
- `_mips_kernel` -> `csrc/mips_topk.cu`, reached through `mips_topk`
  (plain version `mips_topk_plain`);
- `_ivf_scores_kernel` -> `csrc/ivf_scores.cu`, reached through
  `ivf_probe_scores` (plain version `ivf_probe_scores_plain`).

A CPU tensor goes to the plain version, a CUDA tensor to the kernel. The
selection epilogue, `device_rescore`, `device_rescore_residual` and
`merge_topk` were XLA ops in the reference and stay PyTorch ops here.

Selection over the packed maxima is exact (`torch.topk`): the reference's
`approx_max_k` is exact on the CPU, so CPU ids of both packages agree, and
on the card the exact top-k costs little at the merged width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

NEG_INF = float("-inf")
INT32_MIN = -(2**31) + 1      # the reference's packed-invalid sentinel
TOPK_MAX_K = 1024             # the largest k the exact top-k takes

mips_g_launches = LaunchCounter()        # unmasked form
mips_g_mask_launches = LaunchCounter()   # one filter mask for the batch
mips_g_gmask_launches = LaunchCounter()  # one mask row per query
mips_topk_launches = LaunchCounter()
ivf_scores_launches = LaunchCounter()


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-query int8 (codes, scales (B,1) f32), bit-equal to
    the reference's `_quantize_queries` as its jitted scan runs it: XLA
    compiles qmax / 127.0 to qmax * f32(1/127), so the port multiplies by
    that reciprocal too; round half to even."""
    qf = queries.float()
    qmax = qf.abs().amax(dim=1, keepdim=True)
    qscales = torch.where(qmax > 0, qmax * (1.0 / 127.0), torch.ones_like(qmax))
    q8 = torch.clamp(torch.round(qf / qscales), -127, 127).to(torch.int8)
    return q8, qscales


def merge_topk(
    scores_list: torch.Tensor, ids_list: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge partial top-k lists: (B, P*k) -> (B, k), exact, sorted desc,
    equal scores in column order (the reference's `lax.top_k`: a list
    gathered shard-major keeps the lower shard, then the lower slot). The
    selection runs on int64 keys of (score, column)."""
    cols = torch.arange(scores_list.shape[1], device=scores_list.device)
    s, pos = _unpack_keys(torch.topk(_pack_keys(scores_list.float(), cols), k, dim=1).values)
    return s, torch.gather(ids_list, 1, pos.clamp(min=0).long())


def _int_dot(qf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Exact int32 q8 . rows^T from f32 matmuls: every partial sum is an
    integer below 127^2 * 1040 < 2^24, so f32 (TF32 off) holds it exactly;
    a longer D is summed over exact 1024-wide slices in int32."""
    d = qf.shape[1]
    out = None
    for k0 in range(0, d, 1024):
        part = (qf[:, k0 : k0 + 1024] @ rows[:, k0 : k0 + 1024].float().T).to(torch.int32)
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# B1: packed lane-maxima scan (global-scale int8)
# ---------------------------------------------------------------------------


def mips_g_scan_plain(
    q8: torch.Tensor, codes: torch.Tensor, n_valid: int, row_block: int, merge_tiles: int,
    mask: torch.Tensor | None = None, gmasks: torch.Tensor | None = None,
    mask_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the packed lane-maxima scan: (B, n_blocks*128)
    int32, where output block j, lane l holds the max over the merge
    window's M*G rows of (score << log2(G*M)) | (t*G + grp); rows >=
    n_valid, and rows a filter excludes, give INT32_MIN before the
    maximum. `mask` (N_pad,) int8 filters every query alike; `gmasks`
    (G, N_pad) int8 with `mask_ids` (B,) int32 gives query b the row
    gmasks[mask_ids[b]] (an id outside [0, G) excludes every row, as the
    reference's one-hot selector does). Works one output block group at
    a time — the whole (B, N) score matrix would be 4 GB at 1024 x 1M."""
    b = q8.shape[0]
    n_pad = codes.shape[0]
    g_eff = (row_block // 128) * merge_tiles
    mult = 1 << (g_eff.bit_length() - 1)
    span = row_block * merge_tiles
    n_blocks = n_pad // span
    dev = q8.device
    out = torch.empty((b, n_blocks * 128), dtype=torch.int32, device=dev)
    qf = q8.float()
    grp = torch.arange(g_eff, dtype=torch.int32, device=dev).view(1, g_eff, 1)
    local_rows = torch.arange(span, device=dev).view(g_eff, 128)
    if gmasks is not None:
        id_ok = ((mask_ids >= 0) & (mask_ids < gmasks.shape[0])).view(b, 1)
        mids = mask_ids.clamp(0, gmasks.shape[0] - 1).long()
    step = max(1, 16384 // span)          # output blocks per matmul
    with tf32_off():
        for j0 in range(0, n_blocks, step):
            j1 = min(n_blocks, j0 + step)
            s = _int_dot(qf, codes[j0 * span : j1 * span])
            s = s.view(b, j1 - j0, g_eff, 128)
            # multiply, not <<: exact under the packing bound, defined for
            # negative scores
            packed = (s * mult) | grp.unsqueeze(1)
            rows = (torch.arange(j0, j1, device=dev).view(-1, 1, 1) * span + local_rows)
            keep = (rows < n_valid).unsqueeze(0)
            if mask is not None:
                keep = keep & (mask[j0 * span : j1 * span] != 0).view(1, j1 - j0, g_eff, 128)
            elif gmasks is not None:
                sel = (gmasks[:, j0 * span : j1 * span][mids] != 0) & id_ok
                keep = keep & sel.view(b, j1 - j0, g_eff, 128)
            packed = torch.where(keep, packed, INT32_MIN)
            out[:, j0 * 128 : j1 * 128] = packed.amax(dim=2).reshape(b, -1)
    return out


def _check_cuda_args(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors on {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} needs 16-byte aligned tensors")
    return dev


def _check_masks(b: int, n_pad: int, mask, gmasks, mask_ids) -> None:
    if mask is not None and gmasks is not None:
        raise ValueError("pass mask OR gmasks, not both")
    if mask is not None and (mask.dtype != torch.int8 or tuple(mask.shape) != (n_pad,)):
        raise ValueError(f"mask must be int8 ({n_pad},), got {mask.dtype} {tuple(mask.shape)}")
    if gmasks is not None:
        if mask_ids is None:
            raise ValueError("gmasks requires mask_ids")
        if gmasks.dtype != torch.int8 or gmasks.ndim != 2 or gmasks.shape[1] != n_pad:
            raise ValueError(f"gmasks must be int8 (G, {n_pad}), got {gmasks.dtype} {tuple(gmasks.shape)}")
        if not 1 <= gmasks.shape[0] <= 128:
            raise ValueError("at most 128 mask groups per scan")
        if mask_ids.dtype != torch.int32 or tuple(mask_ids.shape) != (b,):
            raise ValueError(f"mask_ids must be int32 ({b},)")


MIPS_G_QUERY_TILE = 128   # queries a block of the B1 kernel


def mips_g_splits(b: int, n_blocks: int, g_eff: int, sms: int, masked: bool = False) -> int:
    """Slices each output block's span is cut into (a power of two that
    divides g_eff): the fewest that give the B1 kernel at least two blocks
    an SM, four for the masked forms, whose passing rows (a year range)
    may sit in a few spans and would leave the card waiting on them. One
    query tile at B <= 128 leaves n_blocks spans for the card's `sms` SMs.
    A slice keeps at least 8 groups; the slices' maxima meet through
    atomicMax."""
    tiles = -(-b // MIPS_G_QUERY_TILE)
    want = (4 if masked else 2) * sms
    s = 1
    while tiles * n_blocks * s < want and s < min(g_eff // 8, 64):
        s *= 2
    return s


def mips_g_batch_order(mask_ids: torch.Tensor) -> torch.Tensor | None:
    """The grouped form's query order: stable by mask id, so that a
    128-query tile holds few signatures and its union of passing rows
    leaves whole corpus groups to skip. None when the batch is a single
    tile (no order helps)."""
    if mask_ids.shape[0] <= MIPS_G_QUERY_TILE:
        return None
    return torch.sort(mask_ids, stable=True).indices


def mips_g_tile_need(
    n_pad: int, mask: torch.Tensor | None = None, gmasks: torch.Tensor | None = None,
    mask_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """The B1 kernel's tile-need map, uint8: for one `mask`, (n_pad/128,)
    with 1 where some row of the 128-row group passes; for `gmasks` +
    `mask_ids`, (query tiles, n_pad/128) with 1 where some row of the
    group passes the mask of some query of the 128-query tile (an id
    outside [0, G) passes nothing). A 0 lets the kernel skip the group:
    every product there would give the INT32_MIN sentinel."""
    n_tiles = n_pad // 128

    def occupied(m: torch.Tensor) -> torch.Tensor:
        # a 128-row group passes somewhere iff one of its 16 int64 words of
        # mask bytes is nonzero: 8x fewer elements than the bytes
        return m.contiguous().view(torch.int64).view(-1, n_tiles, 16).any(dim=2).view(torch.uint8)

    if mask is not None:
        return occupied(mask.view(1, n_pad))[0]
    # row G of the padded map passes nothing: an id outside [0, G), clamped
    # to -1 or G and taken mod G + 1, reads it
    g = gmasks.shape[0]
    occ = torch.nn.functional.pad(occupied(gmasks), (0, 0, 0, 1))          # (G + 1, n_tiles)
    sel = occ.index_select(0, mask_ids.clamp(-1, g).remainder(g + 1))     # (B, n_tiles)
    b = sel.shape[0]
    if b <= MIPS_G_QUERY_TILE:
        return sel.amax(dim=0, keepdim=True)
    sel = torch.nn.functional.pad(sel, (0, 0, 0, -b % MIPS_G_QUERY_TILE))
    return sel.view(-1, MIPS_G_QUERY_TILE, n_tiles).amax(dim=1)


def mips_g_scan(
    q8: torch.Tensor, codes: torch.Tensor, n_valid: int, row_block: int, merge_tiles: int,
    mask: torch.Tensor | None = None, gmasks: torch.Tensor | None = None,
    mask_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """The packed lane-maxima scan: CUDA kernel `csrc/mips_g.cu` for CUDA
    tensors, `mips_g_scan_plain` for CPU tensors. Each form counts its
    launches apart: `mips_g_launches` (no mask), `mips_g_mask_launches`
    (`mask`), `mips_g_gmask_launches` (`gmasks` + `mask_ids`)."""
    b, d = q8.shape
    n_pad = codes.shape[0]
    _check_masks(b, n_pad, mask, gmasks, mask_ids)
    if q8.device.type == "cpu":
        return mips_g_scan_plain(q8, codes, n_valid, row_block, merge_tiles, mask, gmasks, mask_ids)
    extra = [t for t in (mask, gmasks, mask_ids) if t is not None]
    _check_cuda_args("mips_g_scan", q8, codes, *extra)
    if q8.dtype != torch.int8 or codes.dtype != torch.int8:
        raise TypeError("mips_g_scan takes int8 queries and codes")
    if codes.shape[1] != d or d % 16:
        raise ValueError(f"mips_g_scan: D={d} must match the codes and be a multiple of 16")
    n_blocks = n_pad // (row_block * merge_tiles)
    if n_pad % (row_block * merge_tiles) or not 1 <= n_blocks <= 65535:
        raise ValueError("mips_g_scan: bad corpus shape")
    g_eff = (row_block // 128) * merge_tiles
    rows = None   # the output row of each query the kernel sees
    if mask is not None:
        masks, ids, n_masks, counter = mask, None, 1, mips_g_mask_launches
        need = mips_g_tile_need(n_pad, mask=mask)
    elif gmasks is not None:
        perm = mips_g_batch_order(mask_ids)
        if perm is not None:
            q8, mask_ids, rows = q8[perm], mask_ids[perm], perm.to(torch.int32)
        masks, ids, n_masks, counter = gmasks, mask_ids, gmasks.shape[0], mips_g_gmask_launches
        need = mips_g_tile_need(n_pad, gmasks=gmasks, mask_ids=mask_ids)
    else:
        masks, ids, n_masks, counter, need = None, None, 0, mips_g_launches, None
    sms = torch.cuda.get_device_properties(q8.device).multi_processor_count
    splits = mips_g_splits(b, n_blocks, g_eff, sms, masked=masks is not None)
    shape = (b, n_blocks * 128)
    out = (torch.full(shape, INT32_MIN, dtype=torch.int32, device=q8.device) if splits > 1
           else torch.empty(shape, dtype=torch.int32, device=q8.device))
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(q8.device):
        err = lib.ts_mips_g_scan(
            q8.data_ptr(), codes.data_ptr(), out.data_ptr(), b, d, n_pad, int(n_valid),
            row_block, merge_tiles,
            None if masks is None else masks.data_ptr(), None if ids is None else ids.data_ptr(),
            n_masks, None if need is None else need.data_ptr(),
            None if rows is None else rows.data_ptr(), splits,
            ctypes.c_void_p(torch.cuda.current_stream(q8.device).cuda_stream),
        )
    check(lib, err, "mips_g_scan")
    counter.bump()
    return out


def exact_topk_wide(cand: torch.Tensor, k: int, seg: int = 1024):
    """Exact top-k over a wide (B, W) candidate row, two-stage (per-
    segment top-k, then a merge of the winners): a global top-k element is
    beaten by fewer than k elements, hence survives its segment."""
    b, w = cand.shape
    if w <= seg:
        return torch.topk(cand, k, dim=1)
    if w % seg:
        pad = seg - w % seg
        cand = torch.nn.functional.pad(cand, (0, pad), value=INT32_MIN)
        w += pad
    s = w // seg
    k1 = min(k, seg)
    vi1, p1 = torch.topk(cand.view(b, s, seg), k1, dim=2)
    p1 = p1 + (torch.arange(s, device=cand.device) * seg).view(1, s, 1)
    vi2, p2 = torch.topk(vi1.reshape(b, s * k1), k, dim=1)
    return vi2, torch.gather(p1.reshape(b, s * k1), 1, p2)


def auto_merge_tiles(d: int, g: int, n_tiles: int) -> int:
    """Largest M in {4, 2, 1} such that the packed value fits int32, M
    divides the tile count, and the merged selection width stays >= 8192
    (the reference's `_auto_merge_tiles`)."""
    for m in (4, 2):
        if (
            127 * 127 * d * g * m < 2**31
            and n_tiles % m == 0
            and (n_tiles // m) * 128 >= 8192
        ):
            return m
    return 1


def _as_int8(m, shape_last: int, name: str, device) -> torch.Tensor:
    m = torch.as_tensor(m, device=device)
    if m.shape[-1] != shape_last:
        raise ValueError(f"{name} must have {shape_last} columns, got {tuple(m.shape)}")
    return (m != 0).to(torch.int8) if m.dtype != torch.int8 else m


def fused_mips_topk_g(
    queries: torch.Tensor,
    codes: torch.Tensor,
    global_scale: float,
    n_valid: int | None = None,
    mask: torch.Tensor | None = None,
    *,
    k: int = 40,
    row_block: int = 4096,
    recall_target: float = 0.97,
    merge_tiles: int | None = None,
    gmasks: torch.Tensor | None = None,
    mask_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-scale int8 scan (the speed path): (scores (B, k) f32 desc,
    ids (B, k) int32 corpus rows; -inf / -1 for invalid slots).

    queries (B, D) float, quantized per query here; codes (N_pad, D) int8
    with one corpus-wide scale. `mask` (N_pad,) bool/int8, 1 = row passes,
    filters every query; `gmasks` (G <= 128, N_pad) with `mask_ids` (B,)
    gives each query its own mask row (a heterogeneous filtered batch in
    one scan). `recall_target` is accepted for API parity with the
    reference and unused: selection is exact, masked or not."""
    n_pad, d = codes.shape
    if codes.dtype != torch.int8:
        raise ValueError("fused_mips_topk_g requires an int8 corpus")
    if n_pad % row_block != 0:
        raise ValueError(f"corpus rows {n_pad} not a multiple of row_block {row_block}")
    g = row_block // 128
    if row_block % 128 or g & (g - 1):
        raise ValueError("row_block must be a power-of-two multiple of 128")
    if 127 * 127 * d * g >= 2**31:
        raise ValueError(f"packing overflow: D={d} too large for row_block={row_block}")
    n_tiles = n_pad // row_block
    if merge_tiles is None:
        merge_tiles = auto_merge_tiles(d, g, n_tiles)
    elif merge_tiles not in (1, 2, 4):
        raise ValueError(f"merge_tiles must be 1, 2 or 4, got {merge_tiles}")
    elif merge_tiles > 1:
        if 127 * 127 * d * g * merge_tiles >= 2**31:
            raise ValueError(
                f"packing overflow: D={d}, row_block={row_block}, "
                f"merge_tiles={merge_tiles} exceeds int32"
            )
        if n_tiles % merge_tiles:
            raise ValueError(
                f"tile count {n_tiles} not a multiple of merge_tiles={merge_tiles}"
            )
    # the reference's casts; `mips_g_scan` validates the combination
    if mask is not None:
        mask = _as_int8(mask, n_pad, "mask", codes.device).reshape(n_pad)
    if gmasks is not None:
        gmasks = _as_int8(gmasks, n_pad, "gmasks", codes.device)
    if mask_ids is not None:
        mask_ids = torch.as_tensor(mask_ids).to(device=codes.device, dtype=torch.int32)
    n_valid = n_pad if n_valid is None else int(n_valid)
    q8, qscales = quantize_queries(queries)
    cand = mips_g_scan(q8, codes, n_valid, row_block, merge_tiles, mask, gmasks, mask_ids)
    return select_candidates(cand, qscales, global_scale, k, row_block, merge_tiles)


def select_candidates(
    cand: torch.Tensor, qscales: torch.Tensor, global_scale: float,
    k: int, row_block: int, merge_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Epilogue: exact top-k over the packed maxima, then the id/score
    decode of the reference (`mips.py:763-785`). A cell is invalid iff
    every row in it was excluded: its value is then exactly INT32_MIN
    (never a threshold — a restrictive filter may leave only docs that
    score negative)."""
    g_eff = (row_block // 128) * merge_tiles
    g_shift = g_eff.bit_length() - 1
    k_eff = min(k, cand.shape[1])
    vi, pos = exact_topk_wide(cand, k_eff)
    ids = (pos // 128) * (merge_tiles * row_block) + (vi & (g_eff - 1)) * 128 + pos % 128
    valid = vi != INT32_MIN
    # a Python scalar multiplies in f32 (as the reference's f32 constant)
    # without a host->device copy, which would wait for queued work
    gs = float(np.float32(global_scale))
    scores = torch.where(valid, (vi >> g_shift).float() * gs * qscales, NEG_INF)
    ids = torch.where(valid, ids, -1).to(torch.int32)
    if k_eff < k:  # tiny corpora: pad out to the requested k
        pad = k - k_eff
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return scores, ids


# ---------------------------------------------------------------------------
# B5: fused scores + exact running top-k (int8 per-row scales, bf16, f32)
# ---------------------------------------------------------------------------
#
# Ties are exact through one int64 key per (score, row): the order-
# preserving int32 image of the f32 score above 2^31 - 1 - row, so a larger
# key is a larger score, or an equal score at a lower row. Kernel and plain
# version select by the same keys, so equal scores give equal ids.

_LOW32 = 0xFFFFFFFF


def _pack_keys(s: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, C) f32 scores and (C,) or (B, C) int rows -> int64 keys. -0.0
    counts as +0.0 (the reference compares them equal)."""
    s = torch.where(s == 0, torch.zeros_like(s), s)
    bits = s.contiguous().view(torch.int32)
    ordv = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return (ordv << 32) | ((0x7FFFFFFF - rows.to(torch.int64)) & _LOW32)


def _unpack_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (f32 scores, int32 rows; -1 where the score is -inf)."""
    hi = (keys >> 32).to(torch.int32)
    s = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).view(torch.float32)
    rows = (0x7FFFFFFF - (keys & _LOW32)).to(torch.int32)
    return s, torch.where(s == NEG_INF, -1, rows)


def _empty_key(b: int, k: int, device) -> torch.Tensor:
    """Keys of unfilled slots: score -inf, row -1."""
    return _pack_keys(torch.full((b, k), NEG_INF, device=device),
                      torch.full((k,), -1, dtype=torch.int32, device=device))


def mips_topk_plain(
    qk: torch.Tensor, corpus: torch.Tensor, scales: torch.Tensor | None, n_valid: int,
    bias: torch.Tensor | None, k: int, chunk_rows: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the exact top-k scan: scores s = float(q . row)
    [* scales[row]] [+ bias[row]] in f32, -inf for rows >= n_valid; the k
    best (score desc, ties to the lower row) as (scores (B, k) f32, rows
    (B, k) int32, -1 where -inf). `qk` is int8 (int8 corpus, per-query
    codes), bf16 or f32 like the corpus. The per-query dequant factor is
    the caller's (`fused_mips_topk`), applied after selection."""
    b = qk.shape[0]
    n_pad = corpus.shape[0]
    dev = qk.device
    best = _empty_key(b, k, dev)
    qf = qk.float()
    with tf32_off():
        for c0 in range(0, n_pad, chunk_rows):
            c1 = min(n_pad, c0 + chunk_rows)
            if corpus.dtype == torch.int8:
                s = _int_dot(qf, corpus[c0:c1]).float()
            else:
                s = qf @ corpus[c0:c1].float().T
            if scales is not None:
                s = s * scales[c0:c1].float()
            if bias is not None:
                s = s + bias[c0:c1].float()
            rows = torch.arange(c0, c1, device=dev, dtype=torch.int32)
            s = torch.where(rows < n_valid, s, NEG_INF)
            keys = torch.cat([best, _pack_keys(s, rows)], dim=1)
            best = torch.topk(keys, k, dim=1).values
    return _unpack_keys(best)


MIPS_TOPK_GROUP = 128   # corpus rows a group of the B5 kernel


def mips_topk_query_tile(k: int) -> int:
    """Queries a block of the B5 kernel holds: 64, or 16 when k > 64, so
    that the tile's heaps (tile x k int64 keys) fit in shared memory up to
    k = 1024."""
    return 64 if k <= 64 else 16


def mips_topk_spans(b: int, n_groups: int, k: int, sms: int) -> int:
    """Spans each query tile's corpus is cut into: the most that keep the
    grid of (query tile, span) blocks within one wave of the card's `sms`
    SMs (one block an SM), at least 1 and at most one a 128-row group.
    Each span keeps its own k best; `torch.topk` merges the spans."""
    tiles = -(-b // mips_topk_query_tile(k))
    return max(1, min(n_groups, sms // tiles))


def mips_topk_span_groups(count: int, n_spans: int, span: int) -> range:
    """The positions of span `span` in the list of `count` needed groups,
    as the kernel walks them: every n_spans-th, from `span`. Interleaving
    spreads a run of similar rows (many candidates) over all the spans."""
    return range(span, count, n_spans)


def mips_topk_need(bias: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The B5 kernel's need map, bool (n_pad / 128,): a 128-row group is
    needed when it starts below n_valid and some bias value in it is
    above -inf. A group that is not needed would only give (-inf, row)
    keys, which never beat an empty slot."""
    n_groups = bias.shape[0] // MIPS_TOPK_GROUP
    live = (bias.view(n_groups, MIPS_TOPK_GROUP) != NEG_INF).any(dim=1)
    starts = torch.arange(n_groups, device=bias.device) * MIPS_TOPK_GROUP
    return live & (starts < n_valid)


def mips_topk_group_list(need: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(groups int32 (n_groups,), count int32 (1,)): the needed groups in
    increasing order first, then the rest; the count stays on the device,
    so nothing waits for it on the host."""
    order = torch.sort((~need).to(torch.uint8), stable=True).indices.to(torch.int32)
    return order, need.sum(dtype=torch.int32).view(1)


def mips_topk(
    qk: torch.Tensor, corpus: torch.Tensor, scales: torch.Tensor | None, n_valid: int,
    bias: torch.Tensor | None, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k scan: CUDA kernel `csrc/mips_topk.cu` (products and
    each span's k best in the kernel, then one top-k over the spans'
    keys) for CUDA tensors, `mips_topk_plain` for CPU tensors. With a
    bias, groups whose rows are all -inf are skipped (`mips_topk_need`)."""
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"mips_topk: k={k} outside [1, {TOPK_MAX_K}]")
    if qk.device.type == "cpu":
        return mips_topk_plain(qk, corpus, scales, n_valid, bias, k)
    b, d = qk.shape
    n_pad = corpus.shape[0]
    extra = [t for t in (scales, bias) if t is not None]
    _check_cuda_args("mips_topk", qk, corpus, *extra)
    kind = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}.get(corpus.dtype)
    if kind is None or qk.dtype != corpus.dtype:
        raise TypeError(f"mips_topk: queries {qk.dtype}, corpus {corpus.dtype}")
    if corpus.shape[1] != d or (d * corpus.element_size()) % 16 or n_pad % 128:
        raise ValueError(f"mips_topk: bad shapes q {tuple(qk.shape)}, corpus {tuple(corpus.shape)}")
    for t in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != (n_pad,):
            raise ValueError(f"mips_topk: scales and bias must be f32 ({n_pad},)")
    n_valid = min(int(n_valid), n_pad)
    glist = count = None
    if bias is not None:
        glist, count = mips_topk_group_list(mips_topk_need(bias, n_valid))
    sms = torch.cuda.get_device_properties(qk.device).multi_processor_count
    n_spans = mips_topk_spans(b, n_pad // MIPS_TOPK_GROUP, k, sms)
    part = torch.empty((b, n_spans * k), dtype=torch.int64, device=qk.device)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(qk.device):
        err = lib.ts_mips_topk(
            qk.data_ptr(), corpus.data_ptr(),
            None if scales is None else scales.data_ptr(), None if bias is None else bias.data_ptr(),
            None if glist is None else glist.data_ptr(), None if count is None else count.data_ptr(),
            part.data_ptr(), kind, b, d, n_pad, n_valid, k, n_spans,
            ctypes.c_void_p(torch.cuda.current_stream(qk.device).cuda_stream),
        )
    check(lib, err, "mips_topk")
    mips_topk_launches.bump()
    return _unpack_keys(torch.topk(part, k, dim=1).values)


def fused_mips_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None = None,
    n_valid: int | None = None,
    bias: torch.Tensor | None = None,
    *,
    k: int = 10,
    row_block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scan: top-k inner products of each query against the corpus
    (the reference's `fused_mips_topk`).

    queries (B, D) float; corpus (N_pad, D) bf16/f32, or int8 codes with
    per-row `scales` (N_pad,) f32 (then queries are quantized per query
    and the per-query factor multiplies only the emitted scores);
    n_valid: rows >= n_valid score -inf; bias (N_pad,) f32, 0 to keep and
    -inf to exclude a row (how filters reach the exact route).

    Returns (scores (B, k) f32 desc, ids (B, k) int32 corpus rows; -inf /
    -1 for unfilled slots). Ties go to the lower row (the reference's
    order at a tied k-th slot depends on the rest of its batch)."""
    n_pad = corpus.shape[0]
    if n_pad % row_block != 0:
        raise ValueError(f"corpus rows {n_pad} not a multiple of row_block {row_block}")
    n_valid = n_pad if n_valid is None else int(n_valid)
    if corpus.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 corpus requires scales")
        qk, qscales = quantize_queries(queries)
    else:
        qk, qscales = queries.to(corpus.dtype).contiguous(), None
    s, i = mips_topk(qk, corpus, scales, n_valid, bias, k)
    # per-query factor at emission only (the reference's `top_s * qscale`)
    return (s if qscales is None else s * qscales), i


def xla_mips_topk_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None = None,
    n_valid: int | None = None,
    bias: torch.Tensor | None = None,
    *,
    k: int = 10,
    chunk: int = 65536,
    bias_groups: torch.Tensor | None = None,
    mask_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's plain exact scan (its XLA path, `lax.scan` over
    corpus chunks with a running top-k): `fused_mips_topk`'s contract
    computed by `mips_topk_plain` on any device, `chunk` rows at a time.
    `bias_groups` (G, N_pad) with `mask_ids` (B,) gives each query its
    own additive bias row, on top of `bias`."""
    n_pad = corpus.shape[0]
    if n_pad % chunk != 0:
        raise ValueError(f"corpus rows {n_pad} not a multiple of chunk {chunk}")
    n_valid = n_pad if n_valid is None else int(n_valid)
    if corpus.dtype == torch.int8:
        qk, qscales = quantize_queries(queries)
    else:
        qk, qscales = queries.to(corpus.dtype), None
    if bias_groups is None:
        s, i = mips_topk_plain(qk, corpus, scales, n_valid, bias, k, chunk_rows=chunk)
    else:
        mask_ids = torch.as_tensor(mask_ids).to(qk.device).long()
        s = torch.empty((qk.shape[0], k), dtype=torch.float32, device=qk.device)
        i = torch.empty((qk.shape[0], k), dtype=torch.int32, device=qk.device)
        for g in torch.unique(mask_ids).tolist():
            rows = torch.nonzero(mask_ids == g).squeeze(1)
            bg = bias_groups[g].float() + (0.0 if bias is None else bias.float())
            s[rows], i[rows] = mips_topk_plain(qk[rows], corpus, scales, n_valid, bg, k,
                                               chunk_rows=chunk)
    return (s if qscales is None else s * qscales), i


def xla_mips_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None = None,
    n_valid: int | None = None,
    bias: torch.Tensor | None = None,
    *,
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's plain exact top-k over the whole score matrix:
    `xla_mips_topk_scan` in one chunk."""
    return xla_mips_topk_scan(queries, corpus, scales, n_valid, bias, k=k, chunk=corpus.shape[0])


# ---------------------------------------------------------------------------
# B6: IVF probe-major chunk scan (global-scale int8 slabs)
# ---------------------------------------------------------------------------


def _check_ivf_args(queries: torch.Tensor, slabs: torch.Tensor, uids: torch.Tensor) -> None:
    if queries.ndim != 2 or slabs.ndim != 3 or uids.ndim != 1:
        raise ValueError(f"ivf_probe_scores: queries (B, D), slabs (C, R, D), uids (P,); got "
                         f"{tuple(queries.shape)}, {tuple(slabs.shape)}, {tuple(uids.shape)}")
    if queries.shape[1] != slabs.shape[2]:
        raise ValueError(f"ivf_probe_scores: D={queries.shape[1]} vs slabs {tuple(slabs.shape)}")
    if slabs.shape[1] % 128:
        raise ValueError("slab_rows must be a multiple of 128")
    if slabs.dtype != torch.int8:
        raise TypeError(f"ivf_probe_scores takes int8 slabs, got {slabs.dtype}")


def ivf_probe_scores_plain(
    queries: torch.Tensor, slabs: torch.Tensor, uids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the probe-major scan: gather the probed chunks
    slabs[uids] and take the exact int32 products of the quantized
    queries with every row, (B, P*R) with column i*R + r = chunk uids[i],
    row r; plus the per-query scales (B, 1)."""
    _check_ivf_args(queries, slabs, uids)
    q8, qscales = quantize_queries(queries)
    rows = slabs[uids.long()].reshape(-1, slabs.shape[2])
    with tf32_off():
        return _int_dot(q8.float(), rows), qscales


def ivf_probe_scores(
    queries: torch.Tensor, slabs: torch.Tensor, uids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan the unique probed chunks: (cand (B, P*R) int32 raw scores,
    qscales (B, 1) f32). queries (B, D) float, quantized per query here;
    slabs (C, R, D) int8 global-scale codes, R a multiple of 128; uids
    (P,) int32 chunk indices (duplicates and fills point at an empty
    chunk). CUDA kernel `csrc/ivf_scores.cu` for CUDA tensors,
    `ivf_probe_scores_plain` for CPU tensors."""
    if queries.device.type == "cpu":
        return ivf_probe_scores_plain(queries, slabs, uids)
    _check_ivf_args(queries, slabs, uids)
    q8, qscales = quantize_queries(queries)
    uids = uids.to(torch.int32).contiguous()
    _check_cuda_args("ivf_probe_scores", q8, slabs, uids)
    b, d = q8.shape
    c, r, _ = slabs.shape
    p = uids.shape[0]
    if d % 16 or p * (r // 128) > 65535 or p < 1:
        raise ValueError(f"ivf_probe_scores: D={d} must be a multiple of 16 and 1 <= P*R/128 <= 65535")
    cand = torch.empty((b, p * r), dtype=torch.int32, device=q8.device)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(q8.device):
        err = lib.ts_ivf_scores(
            q8.data_ptr(), slabs.data_ptr(), uids.data_ptr(), cand.data_ptr(), b, d, c, r, p,
            ctypes.c_void_p(torch.cuda.current_stream(q8.device).cuda_stream),
        )
    check(lib, err, "ivf_probe_scores")
    ivf_scores_launches.bump()
    return cand, qscales


# ---------------------------------------------------------------------------
# on-device rescore
# ---------------------------------------------------------------------------


def device_rescore(
    queries: torch.Tensor,
    cand_ids: torch.Tensor,
    rescore_corpus: torch.Tensor,
    n_valid: int | None = None,
    *,
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring of oversampled candidates against the bf16 copy:
    gather (B, C, D), bf16 queries, products summed in f32 (TF32 off),
    top-k. Returns (scores (B,k) f32, ids (B,k), -1 where invalid)."""
    n = rescore_corpus.shape[0]
    # ascending ids help the scattered-row gather's locality; rescoring
    # re-ranks, so candidate order is free
    cand_ids = torch.sort(cand_ids, dim=1).values
    safe = cand_ids.clamp(0, n - 1).long()
    cand = rescore_corpus[safe]                                    # (B, C, D)
    qc = queries.to(cand.dtype).float().unsqueeze(2)               # (B, D, 1)
    with tf32_off():
        s = torch.bmm(cand.float(), qc).squeeze(2)                 # (B, C)
    valid = cand_ids >= 0
    if n_valid is not None:
        valid &= cand_ids < int(n_valid)
    s = torch.where(valid, s, NEG_INF)
    top_s, sel = torch.topk(s, k, dim=1)
    top_i = torch.gather(cand_ids, 1, sel)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)


def residual_rows(codes_g: torch.Tensor, gscale: float, res_codes: torch.Tensor,
                  res_scales: torch.Tensor) -> torch.Tensor:
    """The two-level reconstruction gscale * cg + s_r * cr in f32, for
    gathered rows of any leading shape: the one formula of the capacity
    mode's device rescore, the IVF rescore and the engine's host rescore."""
    return (codes_g.float() * float(np.float32(gscale))
            + res_scales[..., None] * res_codes.float())


def device_rescore_residual(
    queries: torch.Tensor,
    cand_ids: torch.Tensor,
    codes_g: torch.Tensor,
    gscale: float,
    res_codes: torch.Tensor,
    res_scales: torch.Tensor,
    n_valid: int | None = None,
    *,
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring from the two-level int8 codes (the 2-bytes/dim
    capacity mode): each candidate is rebuilt as gscale*cg + s_r*cr from
    the scan codes and the residual codes, then scored against the f32
    query with f32 products and sums (TF32 off: TF32 would round the
    ~15-bit reconstruction back to ~10 bits).

    queries (B, D) f32; cand_ids (B, C) int32 rows; codes_g (>= N, D)
    int8 (may carry padding rows); res_codes (N, D) int8; res_scales (N,)
    f32. Returns (scores (B, k) f32, ids (B, k), -1 where invalid)."""
    n = res_codes.shape[0]
    cand_ids = torch.sort(cand_ids, dim=1).values
    safe = cand_ids.clamp(0, n - 1).long()
    cand = residual_rows(codes_g[safe], gscale, res_codes[safe], res_scales[safe])   # (B, C, D)
    with tf32_off():
        s = torch.bmm(cand, queries.float().unsqueeze(2)).squeeze(2)                # (B, C)
    valid = cand_ids >= 0
    if n_valid is not None:
        valid &= cand_ids < int(n_valid)
    s = torch.where(valid, s, NEG_INF)
    top_s, sel = torch.topk(s, k, dim=1)
    top_i = torch.gather(cand_ids, 1, sel)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)
