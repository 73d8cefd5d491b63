"""Whisper-encoder feature backend: the accurate profile's compute core.

Counterpart of ``ser_tpu/_internal/repr/whisper_backend.py``, with the same
``backend_id`` (``jax_whisper_encoder``) so head artifacts load in both
packages. All 30 s windows of a clip go through the encoder in one batched
call; the frame and timestamp arithmetic stays on the host in float64 and is
bit-identical to the JAX backend's. ``dtype="int8"`` is the opt-in W8A8
lane: the projection products in int8 (``models/quant.py``, quantized once
when the encoder is built), everything else in bf16 on the card (float32 on
the CPU), as the JAX backend runs it. A clip's samples go to the backend's
device once and one launch of ``resample_rows`` lays out its padded 16 kHz
windows there (``encoder_backend.StagedClips``). Under a profiler an encode is
the spans ``ser.resample``, ``ser.encode`` and ``ser.fetch``, as
``encoder_backend``'s are.
"""

from __future__ import annotations

import os
from collections.abc import Sequence
from pathlib import Path

import numpy as np
import torch

from ser_tpu_torch._internal.repr.backend import (
    EncodedSequence,
    FeatureMatrix,
    PoolingWindow,
    window_mean_pool,
)
from ser_tpu_torch._internal.repr.encoder_backend import (
    StagedClips,
    count_encode,
    encoder_length,
    random_init_seed,
    resolve_local_model_dir,
)
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.profiling import span
from ser_tpu_torch.models import whisper as whisper_model
from ser_tpu_torch.models.convert import whisper_encoder_state_dict

logger = get_logger(__name__)

BACKEND_ID = "jax_whisper_encoder"


class WhisperEncoderBackend:
    """Whisper encoder embeddings backend (backend_id ``jax_whisper_encoder``)."""

    def __init__(
        self,
        *,
        model_id: str,
        cache_root: Path,
        device: torch.device,
        dtype: str = "float32",
    ) -> None:
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"Unknown dtype {dtype!r} for the Whisper encoder backend.")
        self._model_id = model_id
        self._device = torch.device(device)
        self._config, state = self._resolve_weights(Path(cache_root), model_id)
        on_card = self._device.type == "cuda"
        compute = torch.bfloat16 if dtype == "bfloat16" or (dtype == "int8" and on_card) else torch.float32
        self._encoder = whisper_model.build_whisper_encoder(
            self._config, state, device=self._device, dtype=compute, quant_int8=dtype == "int8"
        )

    def _resolve_weights(self, cache_root, model_id):
        """Local HF weights when present; else, with SER_ALLOW_RANDOM_INIT=1, a
        seeded random init of the size SER_RANDOM_INIT_SIZE names (tiny or full)."""
        model_dir = resolve_local_model_dir(cache_root, model_id)
        if model_dir is not None:
            cfg = whisper_model.whisper_config_from_hf_dir(model_dir)
            params = whisper_model.load_hf_whisper_encoder_params(model_dir, cfg)
            logger.info("Loaded %s encoder weights from %s", model_id, model_dir)
            return cfg, whisper_encoder_state_dict(params)
        if os.environ.get("SER_ALLOW_RANDOM_INIT", "") == "1":
            if os.environ.get("SER_RANDOM_INIT_SIZE", "tiny") == "full":
                # Full production dims with seeded random weights: speed is
                # weight-agnostic, so this measures the real model's cost.
                cfg = whisper_model.WhisperConfig()
            else:
                cfg = whisper_model.WhisperConfig.tiny()
            logger.warning("No local weights for %s; seeded random init (test mode).", model_id)
            state = whisper_model.random_whisper_encoder_state(
                cfg, seed=random_init_seed(BACKEND_ID, model_id), device=self._device
            )
            return cfg, state
        raise RuntimeDependencyError(
            f"No local weights for {model_id!r} under {cache_root}. Pre-download the "
            "HF checkpoint there, or set SER_ALLOW_RANDOM_INIT=1 for test mode."
        )

    @property
    def backend_id(self) -> str:
        return BACKEND_ID

    @property
    def feature_dim(self) -> int:
        return self._config.d_model

    def encode_sequence(self, audio: np.ndarray, sample_rate: int) -> EncodedSequence:
        """Encodes audio: all 30 s windows in one batched call, frames at 20 ms."""
        if audio.ndim != 1 or audio.size == 0:
            raise ValueError("audio must be non-empty mono.")
        n_samples = encoder_length(audio.size, sample_rate)
        chunk = whisper_model.CHUNK_SAMPLES
        n_chunks = max(1, int(np.ceil(n_samples / chunk)))
        with span("ser.resample"):
            windows = [(0, row * chunk, min(chunk, n_samples - row * chunk)) for row in range(n_chunks)]
            chunks = StagedClips([(audio, sample_rate)], self._device).rows(windows, chunk)
        with span("ser.encode"):
            count_encode(chunks, n_samples)
            states = whisper_model.encode_mel_chunks(self._encoder, chunks)

        with span("ser.fetch"):
            states = states.cpu().numpy()
            if not np.all(np.isfinite(states)):
                raise ValueError("Whisper encoder produced non-finite embeddings.")

            n_states = states.shape[1]  # 1500 per 30 s window
            embeddings, starts, ends = [], [], []
            for row in range(n_chunks):
                chunk_samples = min(chunk, n_samples - row * chunk)
                duration = chunk_samples / whisper_model.SAMPLE_RATE
                n_valid = max(1, int(round(n_states * duration / whisper_model.CHUNK_SECONDS)))
                frame_duration = duration / n_valid
                base = row * chunk / whisper_model.SAMPLE_RATE
                frame_starts = base + frame_duration * np.arange(n_valid)
                embeddings.append(states[row, :n_valid])
                starts.append(frame_starts)
                ends.append(frame_starts + frame_duration)

            return EncodedSequence(
                embeddings=np.concatenate(embeddings).astype(np.float32),
                frame_start_seconds=np.concatenate(starts).astype(np.float64),
                frame_end_seconds=np.concatenate(ends).astype(np.float64),
                backend_id=self.backend_id,
            )

    def pool(self, encoded: EncodedSequence, windows: Sequence[PoolingWindow]) -> FeatureMatrix:
        return window_mean_pool(encoded, windows)


__all__ = ["BACKEND_ID", "WhisperEncoderBackend"]
