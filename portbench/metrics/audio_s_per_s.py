"""audio_s_per_s: seconds of audio in the answers completed in the window over its wall seconds (host
clock). A failed file counts as not completed."""

from portbench.harness import readings


def read(ctx):
    return readings.audio_seconds_per_second(ctx)
