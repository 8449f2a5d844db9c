"""Set-up seconds: from the process's start to the window's start (imports,
the card, the kernels' build or load, weights, the traffic's inputs and the
warm-up of every shape the cell uses)."""


def read(ctx):
    return ctx.setup_s
