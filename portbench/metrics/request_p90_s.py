"""request_p90_s: the 90th percentile of every request's latency in the window, host clock."""

from portbench.harness import readings


def read(ctx):
    return readings.latency_quantile(ctx, 90)
