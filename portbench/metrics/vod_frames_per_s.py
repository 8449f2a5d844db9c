"""VOD frames analysed a second on the native route: every frame of the window's VODs over the time from the first VOD's start to the last one's end."""

from portbench import readers


def read(ctx):
    return readers.frames_per_s(ctx)
