"""Whole step, native route: the model's operations over the traced frames, over the traced window, as a share of the card's float32 (TF32) peak, percent."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
