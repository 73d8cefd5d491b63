"""idle_fetch.batch: the card's idle seconds under the program's span ``ser.fetch`` (the states' copy
to the host, the finite checks, frame times and assembly) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.fetch")
