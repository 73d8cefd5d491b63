"""Public API of the PyTorch port: ``infer`` and ``train`` for the four emotion profiles.

Counterparts of ``ser_tpu.api.infer``, returning the same ``InferenceExecution``,
and ``ser_tpu.api.train``, which writes the same head artifact and training
report. Both run on the CUDA card unless the settings ask for the CPU
(``SER_TORCH_DEVICE=cpu`` or ``settings.torch_runtime.device == "cpu"``);
with no card and no such request they raise. The profiles:

- ``accurate``: the Whisper large-v3 encoder;
- ``medium``: the XLS-R 300M encoder (chunked masked encode, float32 retry
  after a non-finite bf16 encode, pooling on the host or, with
  ``SER_DEVICE_POOLING=1``, on the card);
- ``accurate-research``: the emotion2vec encoder (data2vec 2.0 audio, from a
  FunASR ``model.pt``), the medium profile's encode; behind the
  restricted-backend gate (``SER_ENABLE_RESTRICTED_BACKENDS=1`` and recorded
  consent or ``SER_ALLOWED_RESTRICTED_BACKENDS=emotion2vec``), refused with
  ``UnsupportedProfileError`` otherwise;
- ``fast``: handcrafted DSP features (MFCC, chroma, mel, contrast, tonnetz)
  of 3 s frames, computed on the card too, and the head of ``ser_model.pkl``.

``train(profile=...)`` runs readiness and quarantine over the corpus
(``SER_DATASET_FOLDER``; budgets ``SER_MAX_FAILED_FILES``,
``SER_MAX_FAILED_FILE_RATIO`` and its per-corpus and per-class forms,
``SER_MAX_FAILURES_PER_REASON``, ``SER_MIN_REMAINING_PER_CLASS_SPLIT``,
``SER_STRICT_QUARANTINE``), the selected backend's smoke under its deadline
(``SER_TRAINING_SMOKE_TIMEOUT_SECONDS``), the split (``SER_TEST_SIZE``,
``SER_DEV_SIZE``, ``SER_RANDOM_STATE``, ``SER_SPLIT_SALT``), the encode with
the embedding cache under ``SER_TMP_FOLDER``, window pooling and the noise
controls (``SER_MEDIUM_MIN_WINDOW_STD``, ``SER_MEDIUM_MAX_WINDOWS_PER_CLIP``),
the head's fit, the grouped metrics, and the artifact and report under
``SER_MODELS_FOLDER``, which ``infer`` then serves.

Each has the transcript lane (``include_transcript``, on by default as in
the JAX package: it needs a staged HF Whisper checkpoint under the Whisper
download root; with ``use_demucs``, on in the accurate profiles' catalog
entries or by ``WHISPER_DEMUCS``, the staged htdemucs or U-Net checkpoint of
``SER_SEPARATION_MODEL_PATH`` separates the vocals first, on the same device,
else REPET-SIM). ``save_transcript`` writes the timeline as CSV under
``SER_TRANSCRIPTS_FOLDER``, and ``subtitle_output_path`` / ``subtitle_format``
write it as ASS, SRT or VTT subtitles, the files the JAX package writes.
"""

from __future__ import annotations

from pathlib import Path

import ser_tpu_torch._internal.api.runtime as _runtime_api
from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch.profiles import ProfileName
from ser_tpu_torch.runtime.contracts import InferenceExecution, SubtitleFormat


def infer(
    file_path: str | Path,
    *,
    profile: ProfileName | None = "accurate",
    language: str | None = None,
    save_transcript: bool = False,
    include_transcript: bool = True,
    subtitle_output_path: str | None = None,
    subtitle_format: SubtitleFormat | None = None,
    settings: AppConfig | None = None,
) -> InferenceExecution:
    """Runs inference for one audio file (settings default: a fresh env snapshot)."""
    return _runtime_api.infer(
        file_path,
        profile=profile,
        language=language,
        save_transcript=save_transcript,
        include_transcript=include_transcript,
        subtitle_output_path=subtitle_output_path,
        subtitle_format=subtitle_format,
        settings=settings if settings is not None else reload_settings(),
    )


def train(*, profile: ProfileName | None = None, settings: AppConfig | None = None) -> None:
    """Trains the profile's head end to end (settings default: a fresh env snapshot)."""
    _runtime_api.train(profile=profile, settings=settings if settings is not None else reload_settings())


__all__ = ["AppConfig", "InferenceExecution", "infer", "train"]
