"""Public API of the PyTorch port: ``infer`` for the four emotion profiles.

Counterpart of ``ser_tpu.api.infer``, returning the same ``InferenceExecution``.
It runs on the CUDA card unless the settings ask for the CPU
(``SER_TORCH_DEVICE=cpu`` or ``settings.torch_runtime.device == "cpu"``);
with no card and no such request it raises. The profiles:

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

Each has the transcript lane (``include_transcript``, on by default as in
the JAX package: it needs a staged HF Whisper checkpoint under the Whisper
download root). CSV and subtitle export raise ``NotImplementedError``
(``ROADMAP.md``).
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


__all__ = ["AppConfig", "InferenceExecution", "infer"]
