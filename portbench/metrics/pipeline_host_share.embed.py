"""Share of the embed window spent outside the encoder call that the
benchmark hands `embed_missing_slogans` (which returns host arrays, so
it holds the device's time too): catalog paging, `IndexBuilder.add` and
the manifest upserts, on the host clock."""


def read(ctx):
    w, e = ctx.readings.get("window_s"), ctx.readings.get("encode_s")
    if not w or e is None:
        return None
    return 100.0 * (1.0 - e / w)
