"""device_idle.batch: the share of the traced window in which no device activity ran, in %."""

from portbench.harness import readings


def read(ctx):
    return readings.idle_share(ctx)
