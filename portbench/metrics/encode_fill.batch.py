"""encode_fill.batch: the 16 kHz samples of audio in the encoder's rows over the samples those rows
hold, padding rows included, as the program counts them in the traced window, in %."""

from portbench.harness import spans


def read(ctx):
    counts = spans.encode_counts(ctx)
    return None if counts is None else 100.0 * counts["encode_audio_samples"] / counts["encode_row_samples"]
