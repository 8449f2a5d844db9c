"""Host chunk loop, native route: ms from `analyze`'s call to `classify_buffer`'s entry (card synchronised), over the chunks."""

from portbench import readers


def read(ctx):
    return readers.host_loop_ms_per_chunk(ctx)
