"""Set-up seconds: from the process's start to the window's (loading and,
in a checkout's first run, building the kernels and the trace generator,
the inputs, the program, the traces, the cold and the warm proves)."""


def read(ctx):
    return ctx.setup_s
