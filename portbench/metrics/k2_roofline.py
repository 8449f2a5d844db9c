"""K2 (`csrc/residual_block.cu`): least time of its calls, from shapes, over its device time, percent."""

from portbench import readers


def read(ctx):
    return readers.k2_roofline(ctx)
