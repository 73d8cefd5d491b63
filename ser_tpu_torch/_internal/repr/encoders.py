"""Encoder-backend construction for the transformer profiles (medium, accurate, accurate-research).

Counterpart of ``ser_tpu/_internal/repr/encoders.py``: builds the profile's
backend (``jax_xlsr`` for medium, ``jax_whisper_encoder`` for accurate,
``emotion2vec`` for accurate-research, which also searches the ModelScope
root) on the runtime-policy device and dtype, and reuses an instance per
weight provenance (backend, model id, dtype, device, HF and ModelScope cache
roots, random-init mode), since a built backend holds its weights on the
device. A wav2vec2-class backend that switched itself to float32 after a
non-finite encode stays so in the cache, as in the JAX package.
"""

from __future__ import annotations

import os
import threading

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.emotion2vec_backend import Emotion2VecBackend
from ser_tpu_torch._internal.repr.runtime_policy import resolve_feature_runtime
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch._internal.repr.whisper_backend import WhisperEncoderBackend
from ser_tpu_torch.profiles import ProfileName, require_ported

type EncoderBackend = XlsrBackend | WhisperEncoderBackend | Emotion2VecBackend

_BACKENDS = {"jax_xlsr": XlsrBackend, "jax_whisper_encoder": WhisperEncoderBackend, "emotion2vec": Emotion2VecBackend}
_BACKEND_CACHE: dict[tuple, EncoderBackend] = {}
_BACKEND_CACHE_LOCK = threading.Lock()


def resolved_model_id(profile: ProfileName, settings: AppConfig) -> str:
    """The model id the backend will actually load (the settings' override wins; "" for fast).

    Everything that keys on model identity (embedding caches, artifact
    metadata, compatibility checks) uses this, not the catalog's default.
    """
    return {
        "medium": settings.models.medium_model_id,
        "accurate": settings.models.accurate_model_id,
        "accurate-research": settings.models.accurate_research_model_id,
    }.get(profile, "")


def build_encoder_backend(profile: ProfileName, settings: AppConfig) -> EncoderBackend:
    """Builds (or reuses) the encoder backend for one transformer profile."""
    spec = require_ported(profile)
    model_id = settings.profile_model_id(profile)
    runtime = resolve_feature_runtime(spec.backend_id, torch_runtime=settings.torch_runtime)
    cache_key = (
        spec.backend_id,
        model_id,
        runtime.dtype,
        str(runtime.device),
        str(settings.models.huggingface_cache_root),
        str(settings.models.modelscope_cache_root),
        os.environ.get("SER_ALLOW_RANDOM_INIT", "") == "1",
        os.environ.get("SER_RANDOM_INIT_SIZE", "tiny"),
    )
    with _BACKEND_CACHE_LOCK:
        cached = _BACKEND_CACHE.get(cache_key)
    if cached is not None:
        return cached
    # Built outside the lock: loading a checkpoint takes seconds and must not
    # block unrelated cache hits. A racing duplicate build is tolerable.
    # FunASR checkpoints (the emotion2vec family) are staged under the ModelScope hub cache.
    roots = {"modelscope_cache_root": settings.models.modelscope_cache_root} if spec.backend_id == "emotion2vec" else {}
    backend = _BACKENDS[spec.backend_id](
        model_id=model_id,
        cache_root=settings.models.huggingface_cache_root,
        device=runtime.device,
        dtype=runtime.dtype,
        **roots,
    )
    with _BACKEND_CACHE_LOCK:
        return _BACKEND_CACHE.setdefault(cache_key, backend)


__all__ = ["EncoderBackend", "build_encoder_backend", "resolved_model_id"]
