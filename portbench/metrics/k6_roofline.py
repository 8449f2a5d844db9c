"""K6 (`csrc/ssd_scan.cu`): least time of the Mamba-2 SSD scans of the traced head calls (`ssd_layers` layers at their `positions`, `portbench/k6.py`), from shapes, over the device time of the `ssd_scan_*` kernels, percent."""

from portbench import k6


def read(ctx):
    return k6.k6_roofline(ctx)
