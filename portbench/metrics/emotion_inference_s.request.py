"""emotion_inference_s.request: mean over the requests of the ``emotion_inference`` span: profile
execution, the encoder backend, pooling, the head and postprocessing."""

from portbench.harness import readings


def read(ctx):
    return readings.mean_phase(ctx, "emotion_inference")
