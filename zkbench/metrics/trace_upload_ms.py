"""Host milliseconds a proof in the program's span
``zkvm.trace_commit.upload``: the host's side of the transposed trace's
pageable copy to the card (``limbs.from_numpy(..., device)``) and the
freeing of the host array; at least the copy's device time, as a pageable
copy returns once its last chunk is staged."""

from zkbench import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "zkvm.trace_commit.upload")
