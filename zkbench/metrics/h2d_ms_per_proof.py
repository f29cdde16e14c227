"""Device milliseconds of host-to-device copies in the traced window over
the proofs finished in it."""


def read(ctx):
    if ctx.trace is None or not ctx.proofs or not ctx.trace.device:
        return None
    return ctx.trace.seconds_where(lambda n: n.startswith("Memcpy HtoD")) * 1e3 / ctx.proofs
