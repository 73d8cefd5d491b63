"""idle_decode.batch: the card's idle seconds under the program's span ``ser.decode`` (reading and
decoding the call's files (the wait on the decode threads)) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.decode")
