"""Embed: host us of the port's spans `playaid.embed` (each embed call on the dispatch thread, after staging) over the `crops` counted."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_count(ctx, "playaid.embed", "crops", 1.0)
