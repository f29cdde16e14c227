"""Device kernels in the traced window (copies and memsets apart) over the
proofs finished in it."""

from zkbench.trace import is_copy


def read(ctx):
    if ctx.trace is None or not ctx.proofs or not ctx.trace.device:
        return None
    return ctx.trace.count_where(lambda n: not is_copy(n)) / ctx.proofs
