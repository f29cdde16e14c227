"""Wall seconds of the window over the proofs finished in it, all clients
together: one client's mean latency; with several, the card's time a
proof (1 / throughput).  The window runs from the clients' start to the
moment the last proof started in it is on the host."""


def read(ctx):
    return ctx.window_s / ctx.proofs if ctx.proofs else None
