"""Queries a dispatched batch over the window: the scheduler's own
counters (`BatchScheduler.stats()` queries / batches, their change
across the window)."""


def read(ctx):
    return ctx.readings.get("batch_mean")
