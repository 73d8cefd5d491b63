"""Transcript extraction: profile resolution, setup gates, model load, transcribe.

Counterpart of ``ser_tpu/_internal/transcript/extractor.py`` for the
in-process path. ``extract_transcript`` resolves the profile's transcription
settings (catalog defaults under the ``WHISPER_*`` settings), builds the
backend on the device the settings name (the card unless the CPU is asked
for), runs the compatibility check and the device-memory admission, loads the
model and transcribes, timing ``transcription_setup`` and
``transcription_model_load`` as the JAX package does. Unexpected backend
failures surface as ``TranscriptionError``.

With ``settings.transcription.process_isolation`` on and the transcript on
the CPU, the same steps run in a spawned worker (``process_isolation.py``):
the parent's resolved profile crosses as plain fields, as in the JAX
package, and so does its settings snapshot, where the JAX worker re-reads
the environment: the worker then runs on the device the parent chose, with
the settings the caller passed.
"""

from __future__ import annotations

import logging
from dataclasses import asdict, dataclass
from functools import partial

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_feature_runtime
from ser_tpu_torch._internal.runtime import phases
from ser_tpu_torch._internal.transcript.base import BackendRuntimeRequest
from ser_tpu_torch._internal.transcript.hbm_admission import admit_transcription_model
from ser_tpu_torch._internal.transcript.process_isolation import (
    run_isolated_transcription,
    should_use_process_isolated_path,
)
from ser_tpu_torch._internal.transcript.profiling import default_calibration_report_path
from ser_tpu_torch._internal.transcript.whisper_backend import BACKEND_ID, WhisperTranscriber
from ser_tpu_torch.domain import TranscriptWord
from ser_tpu_torch.profiles import ProfileName, require_ported

logger = logging.getLogger(__name__)


class TranscriptionError(RuntimeError):
    """Transcript extraction failed for operational reasons."""


class TranscriptionUnavailableError(TranscriptionError):
    """The transcription backend or its assets cannot be used."""


@dataclass(frozen=True)
class TranscriptionProfile:
    """Resolved transcription configuration for one runtime profile."""

    backend_id: str
    model_name: str
    use_demucs: bool
    use_vad: bool
    decode_strategy: str = "greedy"
    beam_size: int = 5
    length_penalty: float = 1.0


def resolve_transcription_profile(profile: ProfileName, settings: AppConfig) -> TranscriptionProfile:
    """Catalog defaults layered with the active transcription settings."""
    defaults = require_ported(profile).transcription_defaults
    tx = settings.transcription
    return TranscriptionProfile(
        backend_id=tx.backend_id or defaults.backend_id,
        model_name=settings.models.whisper_model.name or defaults.model_name,
        use_demucs=tx.use_demucs,
        use_vad=tx.use_vad,
        decode_strategy=tx.decode_strategy,
        beam_size=tx.beam_size,
        length_penalty=tx.length_penalty,
    )


def _build_transcriber(resolved: TranscriptionProfile, settings: AppConfig) -> tuple[WhisperTranscriber, str]:
    """The backend on its device, and the dtype it computes in."""
    if resolved.backend_id != BACKEND_ID:
        raise TranscriptionUnavailableError(
            f"Unknown transcription backend {resolved.backend_id!r}; the port ships the {BACKEND_ID} backend."
        )
    runtime = resolve_feature_runtime(BACKEND_ID, torch_runtime=settings.torch_runtime)
    transcriber = WhisperTranscriber(
        model_name=resolved.model_name,
        cache_root=settings.models.whisper_download_root,
        device=runtime.device,
        use_vad=resolved.use_vad,
        use_demucs=resolved.use_demucs,
        decode_strategy=resolved.decode_strategy,
        beam_size=resolved.beam_size,
        length_penalty=resolved.length_penalty,
        separation_model_path=settings.transcription.separation_model_path,
    )
    return transcriber, runtime.dtype


def _run_setup_gates(transcriber, resolved: TranscriptionProfile, settings: AppConfig) -> None:
    """Compatibility check, then device-memory admission, before the model loads."""
    report = transcriber.check_compatibility()
    for issue in report.issues:
        if not issue.blocking:
            logger.warning("transcription %s issue: %s", issue.kind, issue.message)
    if report.blocking:
        blocking = "; ".join(i.message for i in report.issues if i.blocking)
        raise TranscriptionUnavailableError(f"Transcription backend {resolved.backend_id!r} blocked: {blocking}")
    decision = admit_transcription_model(
        resolved.model_name,
        config=settings.transcription,
        default_report_path=default_calibration_report_path(settings.tmp_folder),
    )
    if not decision.admitted:
        raise TranscriptionUnavailableError(
            f"Transcription model {resolved.model_name!r} denied by device-memory admission: {decision.reason}"
        )
    logger.debug("transcription admission: %s", decision.reason)


def _runtime_request(resolved: TranscriptionProfile, transcriber: WhisperTranscriber, dtype: str) -> BackendRuntimeRequest:
    return BackendRuntimeRequest(
        model_name=resolved.model_name,
        use_demucs=resolved.use_demucs,
        use_vad=resolved.use_vad,
        device=str(transcriber.device),
        precision_candidates=(dtype,),
    )


def _isolated_setup(resolved_fields: dict, settings: AppConfig) -> WhisperTranscriber:
    """The worker's setup: build, gates and model load, so the compute timeout covers transcription only."""
    resolved = TranscriptionProfile(**resolved_fields)
    transcriber, dtype = _build_transcriber(resolved, settings)
    _run_setup_gates(transcriber, resolved, settings)
    transcriber.load_model(_runtime_request(resolved, transcriber, dtype))
    return transcriber


def _isolated_transcribe(file_path: str, language: str, transcriber: WhisperTranscriber) -> list[TranscriptWord]:
    return transcriber.transcribe(file_path, language=language)


def extract_transcript(
    file_path: str,
    *,
    language: str,
    profile: ProfileName,
    settings: AppConfig,
    timings: dict[str, float] | None = None,
) -> list[TranscriptWord]:
    """Word-level transcript of one audio file.

    Raises ``TranscriptionUnavailableError`` when the model's assets are not
    staged (nothing is downloaded) or admission denies the model.
    """
    if timings is None:
        timings = {}
    resolved = resolve_transcription_profile(profile, settings)
    if should_use_process_isolated_path(resolved.backend_id, settings=settings):
        # The worker's setup and load cannot be timed from here; the pipeline's
        # transcription phase times the whole isolated run.
        try:
            return run_isolated_transcription(
                setup=partial(_isolated_setup, asdict(resolved), settings),
                transcribe=partial(_isolated_transcribe, file_path, language),
                timeout_seconds=settings.transcription.isolation_timeout_seconds,
                backend_id=resolved.backend_id,
            )
        except TranscriptionError:
            raise
        except Exception as err:
            logger.error("Error processing speech extraction: %s", err, exc_info=True)
            raise TranscriptionError("Failed to transcribe audio.") from err

    with phases.timed_phase(phases.PHASE_TRANSCRIPTION_SETUP, timings):
        transcriber, dtype = _build_transcriber(resolved, settings)
        _run_setup_gates(transcriber, resolved, settings)

    with phases.timed_phase(phases.PHASE_TRANSCRIPTION_MODEL_LOAD, timings):
        if transcriber.setup_required():
            transcriber.load_model(_runtime_request(resolved, transcriber, dtype))

    try:
        return transcriber.transcribe(file_path, language=language)
    except TranscriptionError:
        raise
    except Exception as err:
        logger.error("Error processing speech extraction: %s", err, exc_info=True)
        raise TranscriptionError("Failed to transcribe audio.") from err


__all__ = [
    "TranscriptionError",
    "TranscriptionProfile",
    "TranscriptionUnavailableError",
    "extract_transcript",
    "resolve_transcription_profile",
]
