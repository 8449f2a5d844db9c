"""K5 (`csrc/conv1x1_gemm.cu`): least time of its calls at every 1x1 convolution the family's trunk runs on it (`portbench/k5.py` `k5_convs`), from shapes, over its device time, percent."""

from portbench import k5


def read(ctx):
    return k5.k5_roofline(ctx)
