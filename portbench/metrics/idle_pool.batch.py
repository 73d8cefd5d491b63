"""idle_pool.batch: the card's idle seconds under the program's span ``ser.pool`` (the pooling windows
and the pooling) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.pool")
