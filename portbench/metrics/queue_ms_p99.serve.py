"""The 99th percentile of a batch's queue wait (oldest request's submit to
drain): the scheduler's stage ring, reset at the window's start."""


def read(ctx):
    return ctx.readings.get("queue_ms_p99")
