"""Kernel B2 (`csrc/attention.cu`, the fused QK-norm + RoPE attention of
the qwen tower) against its roofline, over the traced window's launches:
the sum of each launch's least time over the sum of its device times.
A launch's shape comes from the trace: B from its grid (Hk, B), S from
its template's SMAX (the encoder pads to widths 64 or 128, so S is SMAX).
Bytes: q, k, v read and the output written in bf16, the cos and sin
tables in f32, the int32 mask and the two norm weights; operations:
QK^T and PV over every causal pair of S positions (an upper bound; the
kernel is bound by its bytes at these shapes either way)."""

import re

from portbench import counts
from portbench.trace import kernels

NAME = "qknorm_rope_attention_kernel"


def b2_bound_ms(b: int, s: int, h: int, hk: int, dh: int) -> float:
    tok = b * s
    nbytes = tok * (2 * h * dh * 2 + 2 * hk * dh * 2) + tok * (dh // 2) * 4 * 2 + tok * 4 + 2 * dh * 4
    ops = 4.0 * h * dh * b * s * (s + 1) / 2
    return counts.bound(nbytes, {"bf16": ops})["bound_ms"]


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    m = ctx.cfg["model"]
    bound = spent = 0.0
    for name, d, args in kernels(s, NAME):
        t = re.search(r"<\s*(\d+)\s*,\s*(\d+)\s*>", name)
        grid = args.get("grid")
        if "bwd" in name or t is None or not grid:
            continue
        dh, smax = int(t.group(1)), int(t.group(2))
        bound += b2_bound_ms(int(grid[1]), smax, m["num_attention_heads"], int(grid[0]), dh)
        spent += 1e3 * d
    return 100.0 * bound / spent if spent else None
