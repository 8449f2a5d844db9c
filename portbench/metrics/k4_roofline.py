"""K4 (`csrc/yuv420_unpack.cu`): least time of its calls by bytes over its device time, percent."""

from portbench import readers


def read(ctx):
    return readers.k4_roofline(ctx)
