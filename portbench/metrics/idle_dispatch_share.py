"""Embed: share of the traced window, percent, in which the card ran nothing while the dispatch thread staged, launched the embed or scattered (`playaid.stage`, `.embed`, `.scatter`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx, ["playaid.stage", "playaid.embed",
                                                "playaid.scatter"])
