"""Staging: host-to-device copy bytes in the traced window over its frames."""

from portbench import readers


def read(ctx):
    return readers.h2d_bytes_per_frame(ctx)
