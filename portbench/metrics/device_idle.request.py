"""device_idle.request: device_idle.batch's reading over a request cell's window."""

from portbench.harness import readings


def read(ctx):
    return readings.idle_share(ctx)
