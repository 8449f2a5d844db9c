"""Host chunk loop, native route: ms of the port's span `playaid.chunk_loop` (the dispatcher made to `finish()` returning) over the `chunks` counted."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_count(ctx, "playaid.chunk_loop", "chunks", 1e-3)
