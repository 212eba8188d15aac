"""Device time a batch of every kernel except B1's scan (the query
quantization, the candidate selection, the bf16 rescore and its top-k),
from the profiler's trace over the calls made in the traced window."""

from portbench.trace import kernels

B1 = "mips_g_scan_kernel"


def read(ctx):
    s, calls = ctx.summary, ctx.readings.get("calls_in_trace")
    if s is None or not calls:
        return None
    other = sum(d / 1e6 for cat, name, _, d, _ in s["device"] if cat == "kernel" and B1 not in name)
    if not kernels(s, B1):
        return None
    return 1e3 * other / calls
