"""XLS-R (wav2vec2) feature backend: the medium profile's compute core.

Counterpart of ``ser_tpu/_internal/repr/wav2vec2_backend.py``, with the same
``backend_id`` (``jax_xlsr``) so head artifacts load in both packages: the
chunked encode (``encoder_backend.chunked_encode``), last-hidden-state
embeddings at 20 ms, mean+std pooling downstream.

Weights: a local HF checkpoint when present; otherwise, with
``SER_ALLOW_RANDOM_INIT=1`` (or ``init="random"``), seeded random weights of
the size ``SER_RANDOM_INIT_SIZE`` names (``tiny``, or ``full`` for XLS-R
300M); otherwise ``RuntimeDependencyError``. A bf16 backend stores its
weights in bf16 (``cast_state_bf16``). After a non-finite bf16 encode the
backend switches to float32 for good, as the JAX package does: the retry and
every later encode run in float32, their attention through kernel K2-f32 on
the card.
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
    chunked_encode,
    chunked_encode_many,
    random_init_seed,
    resolve_local_model_dir,
)
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models import wav2vec2
from ser_tpu_torch.models.param_utils import cast_state_bf16

logger = get_logger(__name__)

BACKEND_ID = "jax_xlsr"


class XlsrBackend:
    """wav2vec2/XLS-R encoder backend (backend_id ``jax_xlsr``)."""

    def __init__(
        self,
        *,
        model_id: str,
        cache_root: Path,
        device: torch.device | str,
        dtype: str = "float32",
        init: str = "auto",
        config: wav2vec2.Wav2Vec2Config | None = None,
        state: dict[str, torch.Tensor] | None = None,
    ) -> None:
        if dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"dtype {dtype!r} is not ported to ser_tpu_torch yet; see ROADMAP.md.")
        self._model_id = model_id
        self._device = torch.device(device)
        if state is not None and config is not None:
            self._config = config
        else:
            self._config, state = self._resolve_weights(Path(cache_root), model_id, init, config)
        self._dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        if self._dtype == torch.bfloat16:
            state = cast_state_bf16(state)
        self._model = wav2vec2.build_wav2vec2_encoder(
            self._config, state, device=self._device, compute_dtype=self._dtype
        )

    def _resolve_weights(self, cache_root: Path, model_id: str, init: str, config):
        model_dir = resolve_local_model_dir(cache_root, model_id)
        allow_random = init == "random" or (init == "auto" and os.environ.get("SER_ALLOW_RANDOM_INIT", "") == "1")
        if model_dir is not None:
            cfg = wav2vec2.config_from_hf_dir(model_dir)
            state = wav2vec2.load_hf_wav2vec2_state(model_dir, cfg)
            logger.info("Loaded %s weights from %s", model_id, model_dir)
            return cfg, state
        if allow_random:
            if config is not None:
                cfg = config
            elif os.environ.get("SER_RANDOM_INIT_SIZE", "tiny") == "full":
                # XLS-R 300M's widths with seeded random weights: speed is
                # weight-agnostic, so this measures the real model's cost.
                cfg = wav2vec2.Wav2Vec2Config()
            else:
                cfg = wav2vec2.Wav2Vec2Config.tiny()
            logger.warning("No local weights for %s; seeded random init (test mode).", model_id)
            state = wav2vec2.random_wav2vec2_state(
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
    def model_id(self) -> str:
        return self._model_id

    @property
    def feature_dim(self) -> int:
        return self._config.hidden_size

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the encoder computes in now (float32 for good after a switch)."""
        return self._dtype

    def _frames_for_length(self, samples: int) -> int:
        return self._config.frames_for_samples(samples)

    def _switch_to_float32(self) -> None:
        """Resets the runtime to float32 for good (the reference's behaviour after a
        non-finite result: the retry AND every later encode run in float32)."""
        if self._dtype == torch.float32:
            return
        logger.warning("%s: resetting runtime to float32 after non-finite output.", self.backend_id)
        state = {name: tensor.float() for name, tensor in self._model.state_dict().items()}
        self._dtype = torch.float32
        self._model = wav2vec2.build_wav2vec2_encoder(
            self._config, state, device=self._device, compute_dtype=torch.float32
        )

    def _encode_batch(self, batch: torch.Tensor | np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Batched masked encode: (B, L) samples → (B, F, d) float32 on the device.

        A batch already on the device (the chunked encode's rows) is taken as
        it is. The valid-frame mask comes from the lengths; padded frames are
        masked out of attention and arbitrary in the output.
        """
        cfg = self._config
        chunks = torch.as_tensor(batch, dtype=torch.float32, device=self._device)
        n_frames = max(1, cfg.frames_for_samples(chunks.shape[1]))
        valid = (np.asarray(lengths, dtype=np.int64) - cfg.frame_receptive_samples) // cfg.frame_stride_samples + 1
        mask = torch.from_numpy(np.arange(n_frames)[None, :] < valid[:, None]).to(self._device)
        with torch.no_grad():
            return self._model(chunks, mask).to(torch.float32)

    def _float32_encode_batch(self):
        self._switch_to_float32()
        return self._encode_batch

    def encode_sequence(self, audio: np.ndarray, sample_rate: int) -> EncodedSequence:
        """Encodes audio into 20 ms-resolution embeddings in one batched call."""
        return chunked_encode(
            audio,
            sample_rate,
            encode_batch=self._encode_batch,
            frames_for_length=self._frames_for_length,
            backend_id=self.backend_id,
            device=self._device,
            float32_encode_batch=self._float32_encode_batch,
        )

    def encode_sequences(self, clips: list[tuple[np.ndarray, int]]) -> list[EncodedSequence]:
        """Encodes many clips with cross-clip chunk batching (training path)."""
        return chunked_encode_many(
            clips,
            encode_batch=self._encode_batch,
            frames_for_length=self._frames_for_length,
            backend_id=self.backend_id,
            device=self._device,
            float32_encode_batch=self._float32_encode_batch,
        )

    def pool(self, encoded: EncodedSequence, windows: Sequence[PoolingWindow]) -> FeatureMatrix:
        """Mean pooling per window (mean+std is applied by the execution pass)."""
        return window_mean_pool(encoded, windows)


__all__ = ["BACKEND_ID", "XlsrBackend"]
