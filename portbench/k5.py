"""K5 (``csrc/conv1x1_gemm.cu``): the 1x1 convolutions a family's trunk
runs on it, their work from shapes, and the reader of ``k5_roofline``.

The port runs every 1x1 convolution of a ResNet-50 ``Bottleneck`` on K5 at
inference on the card: ``conv1``, ``conv3`` and the ``downsample``
projection.  ResNet-18 has no Bottleneck, so the CNN and RNN families run
none there.  Work is counted as ``roofline.py`` counts it: a multiply-add
is two operations, once (K5's three TF32 passes are one product here), and
each byte the convolution needs is read or written once.
"""

from __future__ import annotations

from portbench import program_spans, readers, roofline

K5 = "conv1x1_gemm_kernel"


def k5_convs(family, size):
    """``(c_in, c_out, stride, side in, epilogue)`` of each 1x1 convolution
    the port runs on K5 for ``family`` (``families/<family>.py``, its
    ``TRUNK``) at ``size`` x ``size`` crops, block by block: ``conv1``
    (epilogue ``"relu"``), ``conv3`` (``"residual"``: the block's residual,
    then the ReLU), then the projection where the block has one
    (``"none"``).  Empty for a trunk without Bottleneck blocks."""
    arch = getattr(family, "TRUNK", None)
    if arch not in roofline.STAGES or not roofline.STAGES[arch][1]:
        return []
    convs = []
    for in_planes, planes, out_planes, stride, s, s_out in roofline._blocks(arch, size):
        convs += [(in_planes, planes, 1, s, "relu"), (planes, out_planes, 1, s_out, "residual")]
        if stride != 1 or in_planes != out_planes:
            convs.append((in_planes, out_planes, stride, s, "none"))
    return convs


def conv1x1_counts(crops, c_in, c_out, stride, side, epilogue="relu"):
    """``(flops, bytes)`` of a 1x1 convolution with its folded batch norm
    (and, for ``epilogue`` ``"residual"``, the residual) on ``crops``
    float32 maps of ``side`` x ``side`` x ``c_in``: the pixels the stride
    keeps in, the weights, scale and bias, the output (and the residual)
    once."""
    s_out = -(-side // stride)
    positions = crops * s_out * s_out
    flops = 2 * positions * c_in * c_out
    nbytes = (positions * (c_in + c_out * (2 if epilogue == "residual" else 1))
              + c_in * c_out + 2 * c_out) * roofline.F32
    return flops, nbytes


def least_s(crops, convs):
    """The least seconds of ``crops`` crops at every convolution of
    ``convs`` (from :func:`k5_convs`), each bound on its own."""
    return sum(roofline.least_s(*conv1x1_counts(crops, *conv)) for conv in convs)


def k5_roofline(ctx):
    """K5's share over every 1x1 convolution the family's trunk runs on it:
    a call of ``n`` crops takes the least time of each convolution at its
    shape, over the device time of the K5 kernels it launched, percent.
    None unless the port's ``k5_convs`` count on each ``playaid.embed`` span
    is the family's number of convolutions, so that a change to what K5
    runs silences the metric instead of misreading it."""
    convs = k5_convs(ctx.family, ctx.config["crop_size"])
    calls = sum(len(r.embeds) for r in ctx.traced)
    counted = program_spans.counts_by_span(ctx, "playaid.embed", "k5_convs")
    if not convs or counted != [len(convs)] * calls:
        return None
    return readers._roofline(ctx, K5, lambda n: least_s(n, convs))
