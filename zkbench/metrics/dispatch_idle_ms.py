"""The card's idle milliseconds a proof while the host was in the stages
after the trace commit: the idle gaps whose midpoint lies in the program's
span ``zkvm.composition``, ``zkvm.comp_commit``, ``zkvm.ood``,
``zkvm.deep``, ``zkvm.fri`` or ``zkvm.queries`` (or a child of one), where
the host enqueues launches, reads roots back and works on the host."""

from zkbench import spans

STAGES = ("zkvm.composition", "zkvm.comp_commit", "zkvm.ood", "zkvm.deep", "zkvm.fri", "zkvm.queries")


def read(ctx):
    return spans.idle_ms_in_stages(ctx.trace, STAGES)
