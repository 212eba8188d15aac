"""The whole search step's share of the card's peak: the int8 operations
of the full scan of each batch searched in the traced window (2 B N D at
the int8 peak, 1979 TOP/s) over the traced window's seconds."""

from portbench import counts


def read(ctx):
    s, r = ctx.summary, ctx.readings
    if s is None or not r.get("calls_in_trace"):
        return None
    ops = 2.0 * r["batch"] * r["corpus_rows"] * r["dim"] * r["calls_in_trace"]
    return 100.0 * ops / counts.PEAK_OPS_S["int8"] / s["window_s"]
