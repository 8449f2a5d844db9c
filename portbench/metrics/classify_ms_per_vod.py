"""Classify: ms of `classify_buffer` (scatter done; window gather, head, K3), the card synchronised at both ends, a VOD."""

from portbench import readers


def read(ctx):
    return readers.classify_ms_per_vod(ctx)
