"""The grouped expert kernel (`csrc/moe.cu`, `moe_grouped_gemm_kernel`: the
gate/up and the down products) against its roofline over the traced
window: the sum over width buckets of the least time of that bucket's
grouped work (`deepseek.grouped_bound_ms`, from the change of the
program's counters across the traced window, `stats()["moe"]`: pairs
routed and expert weight sets touched) over the sum of the grouped
launches' device times in the trace. Bounding a bucket's work as a
whole, not each launch, can only understate the share. None where the
program keeps no such counters."""

from portbench import deepseek
from portbench.trace import kernels


def read(ctx):
    s, r = ctx.summary, ctx.readings
    if s is None or not r.get("moe_t1"):
        return None
    a, b = r.get("moe_t0", {}), r["moe_t1"]
    m = deepseek.model_of(ctx.cfg)
    bound = 0.0
    for w, now in b.items():
        was = a.get(w, {"pairs": 0, "experts_touched": 0})
        pairs, touched = now["pairs"] - was["pairs"], now["experts_touched"] - was["experts_touched"]
        if pairs:
            bound += deepseek.grouped_bound_ms(m, pairs, touched)
    spent = 1e3 * sum(d for _, d, _ in kernels(s, deepseek.GROUPED_KERNEL))
    return 100.0 * bound / spent if spent and bound else None
