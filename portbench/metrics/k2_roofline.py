"""K2 (`csrc/residual_block.cu`): least time of its calls at every block the family runs on it (`families/<family>.py` `k2_blocks`), from shapes, over its device time, percent."""

from portbench import readers


def read(ctx):
    return readers.k2_roofline(ctx)
