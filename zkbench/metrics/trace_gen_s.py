"""Host seconds of the native trace generator (``vm.run``) a trace, the
mean over the set-up's pools."""


def read(ctx):
    return sum(ctx.trace_gen_s) / len(ctx.trace_gen_s) if ctx.trace_gen_s else None
