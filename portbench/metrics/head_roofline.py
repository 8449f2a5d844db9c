"""Classify: least time of the work the labels need from the temporal head (2 fighters x the `rows` of each `playaid.classify` x the family's `head_flops`, at the card's float32 (TF32) peak) over the device time of the kernels launched inside the port's spans `playaid.head`, percent."""

from portbench import program_spans, roofline
from portbench.metrics.head_device_ms_per_vod import head_kernel_us


def read(ctx):
    us = head_kernel_us(ctx)
    windows = program_spans.counts_by_span(ctx, "playaid.head", "windows")
    rows = program_spans.counts_by_span(ctx, "playaid.classify", "rows")
    if us is None or not windows or 0 in windows or len({len(us), len(windows), len(rows)}) > 1:
        return None
    flops = ctx.family.head_flops(ctx.config)
    least = sum(roofline.least_s(2 * n * flops, 0) for n in rows)
    return 100.0 * least / (sum(us) / 1e6)
