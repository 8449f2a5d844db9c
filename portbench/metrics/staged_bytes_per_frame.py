"""Staging: the port's `staged_bytes` counter (bytes handed to `PinnedStager.to_device`) over its `frames` counter."""

from portbench import program_spans


def read(ctx):
    return program_spans.ratio(ctx, "staged_bytes", "frames")
