"""Classify: device time of the kernels launched inside the port's spans `playaid.ssm` (each Mamba-2 mixer of the Granite head, `in_proj` to `out_proj`), ms, over the traced VODs."""

from portbench import k6


def read(ctx):
    return k6.ssm_device_ms_per_vod(ctx)
