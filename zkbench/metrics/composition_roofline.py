"""The fused composition kernel's (K3, ``composition_kernel``) share of its
roofline, in %: the least time of evaluating the constraints over the
whole domain of D = blowup T rows for each of the window's proofs
(:func:`zkbench.roofline.composition_work`) over K3's device time in the
traced window."""

from zkbench import roofline as rf

KERNEL = "composition_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.proofs:
        return None
    busy = ctx.trace.seconds_where(lambda n: KERNEL in n)
    if busy <= 0:
        return None
    cfg = ctx.config
    nbytes, ops = rf.composition_work(cfg["trace_length"], cfg["proof"]["blowup"], rf.BOUNDARY_COLUMNS)
    return 100.0 * ctx.proofs * rf.bound_s(nbytes, ops) / busy
