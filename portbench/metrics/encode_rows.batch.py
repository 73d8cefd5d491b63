"""encode_rows.batch: the encoder's rows a call (30 s windows, or bucket rows with their padding
rows), as the program counts them in the traced window."""

from portbench.harness import spans


def read(ctx):
    counts = spans.encode_counts(ctx)
    return None if counts is None else counts["encode_rows"] / counts["encode_calls"]
