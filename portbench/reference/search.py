"""Exact inner-product top-k over a corpus given in row blocks, float32
with TF32 off; and the same over the corpus quantized to int8 with one
global scale (absmax / 127, half-to-even rounding), for the control."""

from __future__ import annotations

import torch

from .towers import tf32_off


def exact_topk(q: torch.Tensor, blocks, k: int):
    """(scores (B, k), rows (B, k) int64) of q against the rows that
    `blocks()` yields as (first_row, (n, D) tensor) pairs."""
    best_s = best_i = None
    with torch.no_grad(), tf32_off():
        for lo, x in blocks():
            s = q @ x.float().T
            ts, ti = torch.topk(s, min(k, s.shape[1]), dim=1)
            ti = ti + lo
            if best_s is None:
                best_s, best_i = ts, ti
            else:
                cs, ci = torch.cat([best_s, ts], 1), torch.cat([best_i, ti], 1)
                best_s, pos = torch.topk(cs, k, dim=1)
                best_i = torch.gather(ci, 1, pos)
    return best_s, best_i


def scores_of(q: torch.Tensor, rows: torch.Tensor, row_fn) -> torch.Tensor:
    """q_b . x_r for the rows r of each query b: (B, k) f32; `row_fn`
    returns the corpus rows at given indices."""
    with torch.no_grad(), tf32_off():
        x = row_fn(rows.reshape(-1)).float().view(*rows.shape, -1)
        return torch.einsum("bd,bkd->bk", q.float(), x)


def int8_blocks(blocks):
    """The blocks, quantized with one global scale over the whole corpus:
    a generator factory like `blocks`."""
    amax = 0.0
    for _, x in blocks():
        amax = max(amax, float(x.abs().max()))
    scale = torch.tensor(amax / 127.0, dtype=torch.float32)

    def quantized():
        for lo, x in blocks():
            s = scale.to(x.device)
            yield lo, torch.clamp(torch.round(x.float() / s), -127, 127) * s
    return quantized, float(scale)
