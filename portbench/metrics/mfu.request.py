"""mfu.request: mfu.batch's arithmetic over a request cell's window."""

from portbench.harness import readings


def read(ctx):
    return readings.mfu(ctx)
