"""resample_on_card.batch: the 16 kHz samples that the encoders' row layout made on the card over
those it made on the card and on the host, as the program counts them in the traced window
(``resample_card_samples``, ``resample_host_samples``), in %. A program without those counters,
or a window in which no row was laid out, reads nothing."""

from ser_tpu_torch._internal.utils import profiling


def read(ctx):
    read_counts = getattr(profiling, "counts", None)
    if ctx.trace is None or not callable(read_counts):
        return None
    counts = read_counts()
    card, host = counts.get("resample_card_samples"), counts.get("resample_host_samples")
    if card is None or host is None or card + host == 0:
        return None
    return 100.0 * card / (card + host)
