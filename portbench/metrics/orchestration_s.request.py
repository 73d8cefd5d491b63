"""orchestration_s.request: mean over the requests of ``workflow_total`` less ``emotion_inference``
(the pipeline's own spans, ``InferenceExecution.phase_timings_seconds``): the API, settings,
boundary and timeline around the emotion pass."""

from portbench.harness import readings


def read(ctx):
    return readings.mean_phase(ctx, "workflow_total", minus="emotion_inference")
