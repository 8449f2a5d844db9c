"""Device, native route: share of the traced window in which the card ran nothing, percent."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
