"""Whisper transcription backend of the port (``backend_id`` ``"jax_whisper"``).

Counterpart of ``ser_tpu/_internal/transcript/jax_whisper_backend.py``. It
keeps that backend's id, so one configuration selects it in both packages
(``ROADMAP.md`` rule (b)). It resolves the staged HF-format checkpoint under
the Whisper download root, loads ``WhisperForTranscription`` on the device it
is given, and transcribes one file: read, resample to 16 kHz, with
``use_demucs`` vocal separation (the staged htdemucs or U-Net checkpoint on
the transcriber's device, else REPET-SIM) then the spectral gate, then the
model's VAD and its decode: greedy, or beam search with ``beam_size`` and
``length_penalty`` (``decode_strategy="beam"``).

Nothing is downloaded: without staged weights the backend reports a blocking
compatibility issue and ``load_model`` raises ``TranscriptionUnavailableError``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ser_tpu_torch._internal.transcript.base import (
    BackendRuntimeRequest,
    CompatibilityIssue,
    CompatibilityReport,
)
from ser_tpu_torch.domain import TranscriptWord

BACKEND_ID = "jax_whisper"


class WhisperTranscriber:
    """Whisper transcription over the port's encoder-decoder."""

    def __init__(
        self,
        *,
        model_name: str,
        cache_root: Path,
        device: torch.device | str = "cpu",
        use_vad: bool = True,
        use_demucs: bool = False,
        decode_strategy: str = "greedy",
        beam_size: int = 5,
        length_penalty: float = 1.0,
        separation_model_path: Path | None = None,
    ) -> None:
        self._model_name = model_name
        self._cache_root = Path(cache_root)
        self._device = torch.device(device)
        self._use_vad = use_vad
        self._use_demucs = use_demucs
        self._decode_strategy = decode_strategy
        self._beam_size = beam_size
        self._length_penalty = length_penalty
        self._separation_model_path = separation_model_path
        self._model = None

    def _assets_dir(self) -> Path | None:
        """The staged HF-format checkpoint of the configured model, if any."""
        for candidate in (self._cache_root / self._model_name, self._cache_root / self._model_name.replace("/", "--")):
            if candidate.is_dir() and any(candidate.iterdir()):
                return candidate
        return None

    def assets_available(self) -> bool:
        return self._assets_dir() is not None

    @property
    def backend_id(self) -> str:
        return BACKEND_ID

    @property
    def device(self) -> torch.device:
        return self._device

    def check_compatibility(self) -> CompatibilityReport:
        issues = []
        if not self.assets_available():
            issues.append(
                CompatibilityIssue(
                    kind="functional",
                    message=f"Whisper assets for {self._model_name!r} missing under {self._cache_root}.",
                    blocking=True,
                )
            )
        if self._use_demucs:
            issues.append(
                CompatibilityIssue(
                    kind="noise",
                    message=(
                        "Separation runs the staged neural separator (htdemucs or the U-Net) when "
                        "SER_SEPARATION_MODEL_PATH points at a checkpoint; otherwise the built-in REPET-SIM "
                        "separator + spectral gate take the lane."
                    ),
                )
            )
        return CompatibilityReport(issues=tuple(issues))

    def setup_required(self) -> bool:
        return self._model is None

    def prepare_assets(self) -> None:
        if not self.assets_available():
            from ser_tpu_torch._internal.transcript.extractor import TranscriptionUnavailableError

            raise TranscriptionUnavailableError(f"Whisper assets for {self._model_name!r} must be staged locally.")

    def load_model(self, request: BackendRuntimeRequest | None = None) -> None:
        assets = self._assets_dir()
        if assets is None:
            self.prepare_assets()
            assets = self._assets_dir()
            if assets is None:
                from ser_tpu_torch._internal.transcript.extractor import TranscriptionUnavailableError

                raise TranscriptionUnavailableError(f"Whisper assets for {self._model_name!r} must be staged locally.")
        if self._model is None:
            from ser_tpu_torch.models.whisper import WhisperForTranscription

            dtype = "bfloat16" if request is None else request.precision_candidates[0]
            self._model = WhisperForTranscription.from_pretrained_dir(
                assets,
                device=self._device,
                compute_dtype=dtype if dtype in ("bfloat16", "float32") else "float32",
                decode_strategy=self._decode_strategy,
                beam_size=self._beam_size,
                length_penalty=self._length_penalty,
            )

    def transcribe(self, file_path: str, *, language: str = "en") -> list[TranscriptWord]:
        """Transcribes one audio file to word-level timestamps."""
        if self._model is None:
            self.load_model()
        from ser_tpu_torch._internal.utils.audio_io import read_audio_file, resample_audio

        audio, sr = read_audio_file(file_path)
        audio16k = resample_audio(audio, sr, 16000)
        if self._use_demucs:
            from ser_tpu_torch._internal.utils.denoise import spectral_gate_denoise
            from ser_tpu_torch._internal.utils.source_separation import separate_vocals_auto

            audio16k = spectral_gate_denoise(
                separate_vocals_auto(
                    audio16k, 16000, model_path=self._separation_model_path, device=self._device
                )
            )
        return self._model.transcribe_words(audio16k, language=language, use_vad=self._use_vad)


__all__ = ["BACKEND_ID", "WhisperTranscriber"]
