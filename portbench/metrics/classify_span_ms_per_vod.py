"""Classify: ms from each of the port's spans `playaid.classify` (`classify_buffer`) to the end of the next `playaid.labels_to_host`, a VOD."""

from portbench import program_spans


def read(ctx):
    return program_spans.classify_ms_per_vod(ctx)
