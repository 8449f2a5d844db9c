"""Staging: host us of the port's spans `playaid.stage` (`PinnedStager.to_device`, its slot waits inside) over the `chunks` counted."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_count(ctx, "playaid.stage", "chunks", 1.0)
