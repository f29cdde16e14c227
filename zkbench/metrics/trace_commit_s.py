"""The mean of the prover's own ``stage_seconds["trace_commit"]`` over the
traced window's proofs: the host transpose of the trace, its copy to the
card, the interpolation, the class extensions, the row hashes and the
Merkle heap, up to a synchronisation of the card at the stage's end."""


def read(ctx):
    vals = [r.stages["trace_commit"] for r in ctx.records if r.stages and "trace_commit" in r.stages]
    return sum(vals) / len(vals) if vals else None
