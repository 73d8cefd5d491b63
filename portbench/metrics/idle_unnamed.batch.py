"""idle_unnamed.batch: the card's idle seconds that no program span and no torch op on the host
covers (the trace's label ``no torch op on the host``) over the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.unnamed_share(ctx)
