"""idle_encode.batch: the card's idle seconds under the program's span ``ser.encode`` (laying the audio
into the encoder's padded rows, the copy to the card and launching the encoder) over the traced
window, in %."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_share(ctx, "ser.encode")
