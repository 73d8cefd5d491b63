"""idle_classify.batch: the card's idle seconds under the program's span ``ser.classify`` (the head,
the frame predictions and the postprocessing) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.classify")
