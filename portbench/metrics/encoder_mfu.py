"""Model FLOPs of the real tokens of the encoder calls that started in the
traced window (`counts.model_flops`: 2 x non-embedding parameters a token plus
the attention products over each sequence's real length), over the
traced window's seconds at the bf16 dense peak (989 TFLOP/s)."""

from portbench import counts


def read(ctx):
    s, r = ctx.summary, ctx.readings
    if s is None:
        return None
    lengths = [n for t, ls in r.get("encode_calls", ()) if r["trace_t0"] <= t < r["trace_t1"]
               for n in ls]
    if not lengths:
        return None
    flops = counts.model_flops(ctx.cfg["model"], ctx.cfg["family"], lengths)
    return counts.mfu_percent(flops, s["window_s"])
