"""mfu.batch: model FLOPs the completed answers' inputs need over the window's seconds at the card's bf16
peak (989 TFLOP/s), in %: every 30 s window for Whisper, each chunk's valid frames for wav2vec2."""

from portbench.harness import readings


def read(ctx):
    return readings.mfu(ctx)
