"""Embed: device time of the kernels that ran before each `classify_buffer` span opened, in us, over the crops."""

from portbench import readers


def read(ctx):
    return readers.embed_device_us_per_crop(ctx)
