"""The speed path's scan: per-query int8 queries against a global-scale
int8 corpus, packed lane maxima, exact selection and the bf16 rescore.

Port of theoremsearch_tpu/kernels/mips.py (the global-scale part). The
TPU kernel `_mips_g_kernel` becomes the hand-written CUDA kernel in
`csrc/mips_g.cu`, reached through `mips_g_scan`; `mips_g_scan_plain` is
its plain PyTorch version. A CPU tensor goes to the plain version, a
CUDA tensor to the kernel. The selection epilogue, `device_rescore` and
`merge_topk` were XLA ops in the reference and stay PyTorch ops here.

Selection is exact (`torch.topk`): the reference's `approx_max_k` is
exact on the CPU, so CPU ids of both packages agree, and on the card the
exact top-k costs little at the merged width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

NEG_INF = float("-inf")
INT32_MIN = -(2**31) + 1      # the reference's packed-invalid sentinel

mips_g_launches = LaunchCounter()


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
    """Merge partial top-k lists: (B, P*k) -> (B, k), exact, sorted desc."""
    s, i = torch.topk(scores_list, k, dim=1)
    return s, torch.gather(ids_list, 1, i)


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


def mips_g_scan_plain(
    q8: torch.Tensor, codes: torch.Tensor, n_valid: int, row_block: int, merge_tiles: int
) -> torch.Tensor:
    """Plain version of the packed lane-maxima scan: (B, n_blocks*128)
    int32, where output block j, lane l holds the max over the merge
    window's M*G rows of (score << log2(G*M)) | (t*G + grp), and rows
    >= n_valid give INT32_MIN. Works one output block group at a time —
    the whole (B, N) score matrix would be 4 GB at 1024 x 1M."""
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
            packed = torch.where(rows.unsqueeze(0) < n_valid, packed, INT32_MIN)
            out[:, j0 * 128 : j1 * 128] = packed.amax(dim=2).reshape(b, -1)
    return out


def mips_g_scan(
    q8: torch.Tensor, codes: torch.Tensor, n_valid: int, row_block: int, merge_tiles: int
) -> torch.Tensor:
    """The packed lane-maxima scan: CUDA kernel `csrc/mips_g.cu` for CUDA
    tensors, `mips_g_scan_plain` for CPU tensors."""
    if q8.device.type == "cpu":
        return mips_g_scan_plain(q8, codes, n_valid, row_block, merge_tiles)
    if q8.device.type != "cuda" or codes.device != q8.device:
        raise ValueError(f"mips_g_scan: q8 on {q8.device}, codes on {codes.device}")
    b, d = q8.shape
    n_pad = codes.shape[0]
    if q8.dtype != torch.int8 or codes.dtype != torch.int8:
        raise TypeError("mips_g_scan takes int8 queries and codes")
    if codes.shape[1] != d or d % 16:
        raise ValueError(f"mips_g_scan: D={d} must match the codes and be a multiple of 16")
    if not (q8.is_contiguous() and codes.is_contiguous()):
        raise ValueError("mips_g_scan takes contiguous tensors")
    if q8.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("mips_g_scan needs 16-byte aligned tensors")
    n_blocks = n_pad // (row_block * merge_tiles)
    if n_pad % (row_block * merge_tiles) or not 1 <= n_blocks <= 65535:
        raise ValueError("mips_g_scan: bad corpus shape")
    out = torch.empty((b, n_blocks * 128), dtype=torch.int32, device=q8.device)
    lib = load()
    err = lib.ts_mips_g_scan(
        q8.data_ptr(), codes.data_ptr(), out.data_ptr(), b, d, n_pad, int(n_valid),
        row_block, merge_tiles,
        ctypes.c_void_p(torch.cuda.current_stream(q8.device).cuda_stream),
    )
    check(lib, err, "mips_g_scan")
    mips_g_launches.bump()
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


def fused_mips_topk_g(
    queries: torch.Tensor,
    codes: torch.Tensor,
    global_scale: float,
    n_valid: int | None = None,
    *,
    k: int = 40,
    row_block: int = 4096,
    recall_target: float = 0.97,
    merge_tiles: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-scale int8 scan (the speed path): (scores (B, k) f32 desc,
    ids (B, k) int32 corpus rows; -inf / -1 for invalid slots).

    queries (B, D) float, quantized per query here; codes (N_pad, D) int8
    with one corpus-wide scale. `recall_target` is accepted for API parity
    with the reference and unused: selection is exact. Filter masks are
    not ported yet."""
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
    n_valid = n_pad if n_valid is None else int(n_valid)
    q8, qscales = quantize_queries(queries)
    cand = mips_g_scan(q8, codes, n_valid, row_block, merge_tiles)
    return select_candidates(cand, qscales, global_scale, k, row_block, merge_tiles)


def select_candidates(
    cand: torch.Tensor, qscales: torch.Tensor, global_scale: float,
    k: int, row_block: int, merge_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Epilogue: exact top-k over the packed maxima, then the id/score
    decode of the reference (`mips.py:763-785`)."""
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
