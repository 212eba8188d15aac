"""Kernel B1 (`csrc/mips_g.cu`, the unmasked packed scan) against its
roofline: the least time for its work (`bound`: 2 B N D int8 operations
at the int8 peak, or the int8 codes and queries read once at 3.35 TB/s,
whichever is longer) over its mean device time in the profiler's trace.
The candidates it writes are left out of the bytes: the scan is bound by
its operations at this shape by a factor of three."""

from portbench import counts
from portbench.trace import kernels

NAME = "mips_g_scan_kernel"


def b1_bound_ms(b: int, n: int, d: int) -> float:
    return counts.bound(n * d + b * d, {"int8": 2.0 * b * n * d})["bound_ms"]


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    ks = kernels(s, NAME)
    if not ks:
        return None
    mean_ms = 1e3 * sum(d for _, d, _ in ks) / len(ks)
    r = ctx.readings
    return 100.0 * b1_bound_ms(r["batch"], r["corpus_rows"], r["dim"]) / mean_ms
