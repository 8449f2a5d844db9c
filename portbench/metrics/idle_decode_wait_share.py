"""Host chunk loop: share of the traced window, percent, in which the card ran nothing while the dispatch thread waited for a decoded chunk (`playaid.dispatch_wait`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx, ["playaid.dispatch_wait"])
