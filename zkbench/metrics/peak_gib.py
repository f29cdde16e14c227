"""The card's peak allocated memory over the window (the allocator's peak,
reset when the window opens), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
