"""The NTT stage network's (K1, ``ntt_stages_kernel``) share of its
roofline, in %: the least time of the transforms the window's proofs
cannot do without (:func:`zkbench.roofline.proof_ntt_work`, from the
configuration's T, blowup and 28 columns) over K1's device time in the
traced window."""

from zkbench import roofline as rf

KERNEL = "ntt_stages_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.proofs:
        return None
    busy = ctx.trace.seconds_where(lambda n: KERNEL in n)
    if busy <= 0:
        return None
    cfg = ctx.config
    nbytes, ops = rf.proof_ntt_work(cfg["trace_length"], cfg["proof"]["blowup"], cfg["trace_width"],
                                    cfg["composition_columns"])
    return 100.0 * ctx.proofs * rf.bound_s(nbytes, ops) / busy
