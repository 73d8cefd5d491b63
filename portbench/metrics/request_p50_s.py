"""request_p50_s: the median latency of every request in the window, host clock from call to return."""

from portbench.harness import readings


def read(ctx):
    return readings.latency_quantile(ctx, 50)
