"""Host milliseconds a proof in the program's span
``zkvm.trace_commit.transpose``: the trace's (28, T, 8) limbs transposed to
(28, 8, T) on the host (``pipeline._trace_limbs_t``, with the limbs' first
conversion on a trace's first prove), before its copy to the card."""

from zkbench import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "zkvm.trace_commit.transpose")
