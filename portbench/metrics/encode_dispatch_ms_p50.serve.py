"""The median host time of a batch's encoder dispatch (tokenize, pad,
launch; the device runs on): the scheduler's stage ring, reset at the
window's start."""


def read(ctx):
    return ctx.readings.get("encode_ms_p50")
