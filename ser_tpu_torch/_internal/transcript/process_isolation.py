"""Transcription in a spawned worker process: routing and the run.

Counterpart of ``ser_tpu/_internal/transcript/process_isolation.py``. No
backend needs isolation (the reference isolated ctranslate2 for an OpenMP
clash); it is a configuration opt-in (``settings.transcription.
process_isolation``), and, as in the JAX package, it is honoured only when
the transcript runs on the CPU (``SER_TORCH_DEVICE=cpu``): the JAX package
never isolates an accelerator run, and on the CUDA card the opt-in is
ignored the same way (``ROADMAP.md``, Queue 3). The worker starts from the
``spawn`` context (``_internal/runtime/worker_lifecycle.py``).
"""

from __future__ import annotations

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime.worker_lifecycle import run_attempt_in_spawned_process
from ser_tpu_torch.domain import TranscriptWord


def should_use_process_isolated_path(backend_id: str, *, settings: AppConfig) -> bool:
    """True when the transcript should run in a spawned worker: opted in, and on the CPU."""
    if not settings.transcription.process_isolation:
        return False
    return resolve_device(settings.torch_runtime.device).type == "cpu"


def run_isolated_transcription(*, setup, transcribe, timeout_seconds: float, backend_id: str) -> list[TranscriptWord]:
    """Runs setup (build, gates, load) and then the transcription in a spawned worker."""
    return run_attempt_in_spawned_process(
        setup=setup,
        compute=transcribe,
        timeout_seconds=timeout_seconds,
        profile=f"transcription:{backend_id}",
    )


__all__ = ["run_isolated_transcription", "should_use_process_isolated_path"]
