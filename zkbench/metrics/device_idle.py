"""Share of the traced window in which no kernel, copy or memset ran on the
card, in %: the window less the union of the device's intervals."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
