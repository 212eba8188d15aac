"""The deepseek tower's model FLOPs (`deepseek.model_flops`: 2 x the active
non-embedding parameters a real token, the picked and shared experts, the
router, the latent attention's projections and the dense layer's SwiGLU,
plus the latent attention's products over each sequence's causal pairs)
of the real tokens of the encoder calls that started in the traced
window, over the traced window's seconds at the bf16 dense peak (989
TFLOP/s)."""

from portbench import counts, deepseek


def read(ctx):
    s, r = ctx.summary, ctx.readings
    if s is None:
        return None
    lengths = [n for t, ls in r.get("encode_calls", ()) if r["trace_t0"] <= t < r["trace_t1"]
               for n in ls]
    if not lengths:
        return None
    return counts.mfu_percent(deepseek.model_flops(deepseek.model_of(ctx.cfg), lengths),
                              s["window_s"])
