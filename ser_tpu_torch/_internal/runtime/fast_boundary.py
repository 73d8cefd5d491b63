"""Fast-profile inference boundary: load the head, run one attempt.

Counterpart of ``ser_tpu/_internal/runtime/fast_boundary.py``. The fast
profile's catalog budgets are all zero (no timeout, no retries), so the JAX
package's retry policy runs exactly one attempt; the port runs that one
attempt directly, on the settings' device, and an error raises to the
caller, as in the windowed boundary (``profile_boundary.py``). The single
flight lock and the retry ladder wait for a later slice (``ROADMAP.md``).
"""

from __future__ import annotations

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models import artifacts, emotion_model
from ser_tpu_torch._internal.runtime.errors import ModelLoadError, ModelUnavailableError
from ser_tpu_torch.runtime.contracts import InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult


def run_fast_inference(request: InferenceRequest, *, settings: AppConfig) -> InferenceResult:
    """Runs one fast-profile inference: the ``ser_tpu_mlp`` head over handcrafted frame features."""
    try:
        loaded = emotion_model.load_model(settings=settings, profile="fast")
    except FileNotFoundError as err:
        raise ModelUnavailableError(
            f"No trained fast-profile artifact at {settings.models.model_file}. Train it with ser_tpu first.",
            profile="fast",
        ) from err
    except artifacts.ArtifactError as err:
        raise ModelLoadError(str(err), profile="fast") from err
    return emotion_model.predict_emotions_detailed(request.file_path, settings=settings, loaded=loaded)


__all__ = ["run_fast_inference"]
