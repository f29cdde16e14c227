"""The 95th percentile of single-proof latency, from handing the trace to
the prover to holding the wire bytes, over every proof of the window."""

import statistics


def read(ctx):
    lat = [r.t1 - r.t0 for r in ctx.records]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
