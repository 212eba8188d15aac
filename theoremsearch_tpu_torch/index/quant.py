"""Embedding quantization on tensors (port of theoremsearch_tpu/index/quant.py).

Codes are bit-equal to the reference's: the global scale is
float(amax)/127.0 in Python double, applied as a float32 divisor, and
rounding is half to even (`torch.round`), as in the reference's native
path (`native/theoremsearch_native.cpp`, nearbyint of x / scale).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import tf32_off

_CHUNK_ROWS = 262_144


def _as_tensor(x, device=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(device) if device is not None else t


def _chunks(n: int, d: int):
    step = max(1, min(_CHUNK_ROWS, (1 << 26) // max(d, 1)))
    return range(0, n, step), step


def quantize_global_int8(
    x, clip_pct: float = 100.0, device=None
) -> tuple[torch.Tensor, float]:
    """Global-scale symmetric int8: ONE scale for the whole corpus.
    Returns (codes int8 (N, D) on `device` (default: x's device), scale).
    Works in row chunks, so the f32 temporaries stay bounded."""
    xt = _as_tensor(x)
    dev = torch.device(device) if device is not None else xt.device
    n, d = xt.shape
    rng, step = _chunks(n, d)
    if clip_pct >= 100.0:
        amax = 0.0
        for i in rng:
            amax = max(amax, float(xt[i : i + step].to(dev).float().abs().max()))
    else:
        amax = float(np.percentile(np.abs(xt.float().cpu().numpy()), clip_pct))
    scale = amax / 127.0 if amax > 0 else 1.0
    div = torch.tensor(np.float32(scale), device=dev)
    codes = torch.empty((n, d), dtype=torch.int8, device=dev)
    for i in rng:
        xc = xt[i : i + step].to(dev).float()
        codes[i : i + step] = torch.clamp(torch.round(xc / div), -127, 127).to(torch.int8)
    return codes, float(scale)


def quantize_int8(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (codes int8 (N, D), scales f32 (N,)),
    scale = max|row| / 127 in f32 (1.0 for an all-zero row)."""
    xt = _as_tensor(x, device).float()
    absmax = xt.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    codes = torch.clamp(torch.round(xt / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def dequantize_int8(codes: torch.Tensor, scales) -> torch.Tensor:
    """codes * scale(s): per-row scales (N,) or one global float."""
    if isinstance(scales, torch.Tensor):
        return codes.float() * scales[:, None]
    return codes.float() * np.float32(scales)


def quantize_residual_int8(
    x, codes_g, gscale: float, chunk: int = _CHUNK_ROWS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes of the residual x - gscale * codes_g (the
    two-level capacity mode: the global-scale codes are the coarse level,
    the residual's per-row codes the fine one, ~15 effective bits at one
    extra byte a dimension). Returns (res_codes int8 (N, D), res_scales
    f32 (N,)) on codes_g's device, computed there in row chunks; sized
    from x, since codes_g may carry padding rows."""
    xt = _as_tensor(x)
    cg = _as_tensor(codes_g)
    dev = cg.device
    n, d = xt.shape
    g = torch.tensor(np.float32(gscale), device=dev)
    out_codes = torch.empty((n, d), dtype=torch.int8, device=dev)
    out_scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        r = xt[s : s + chunk].to(dev).float() - g * cg[s : s + chunk].float()
        out_codes[s : s + chunk], out_scales[s : s + chunk] = quantize_int8(r)
    return out_codes, out_scales


def dequantize_residual_int8(codes_g, gscale: float, res_codes, res_scales) -> torch.Tensor:
    """gscale * codes_g + res_scales * res_codes, in f32."""
    return (_as_tensor(codes_g).float() * float(np.float32(gscale))
            + _as_tensor(res_scales)[:, None] * _as_tensor(res_codes).float())


def int8_scores(queries, codes, scales) -> torch.Tensor:
    """The reference's plain int8 scoring: q @ codes.T with f32 products
    and sums (TF32 off), then the per-row rescale. (B, N) f32, on the
    queries' device."""
    q = _as_tensor(queries).float()
    with tf32_off():
        s = q @ _as_tensor(codes, q.device).float().T
    return s * _as_tensor(scales, q.device).float()[None, :]
