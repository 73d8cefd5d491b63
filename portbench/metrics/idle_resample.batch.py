"""idle_resample.batch: the card's idle seconds under the program's span ``ser.resample`` (resampling
to 16 kHz) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.resample")
