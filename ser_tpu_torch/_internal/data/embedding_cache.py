"""Content-addressed NPZ cache of encoded sequences.

Counterpart of ``ser_tpu/_internal/data/embedding_cache.py``: an entry's key
is the sha256 of the audio (float32 PCM, or the file's bytes) followed by
the encode identity (format version, backend, model id, revision, device,
dtype), so an entry the JAX package stored for the same identity has the
same file name here. Stores are atomic (a per-writer temporary name, then
``replace``); a corrupt entry is classified by the failure taxonomy
(``training_readiness.classify_failure``: recompute), dropped, and read as
a miss.
"""

from __future__ import annotations

from hashlib import sha256
from pathlib import Path

import numpy as np

from ser_tpu_torch._internal.repr import EncodedSequence
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

_CACHE_FORMAT_VERSION = 1


class EmbeddingCache:
    """NPZ per-utterance cache of ``EncodedSequence`` payloads."""

    def __init__(
        self,
        *,
        root: str | Path,
        backend_id: str,
        model_id: str,
        revision: str,
        device: str,
        dtype: str,
    ) -> None:
        self._root = Path(root)
        self._identity = (
            f"v{_CACHE_FORMAT_VERSION}|{backend_id}|{model_id}|{revision}|{device}|{dtype}"
        )
        self._backend_id = backend_id

    def _key(self, file_path: str, audio: np.ndarray | None) -> str:
        if audio is not None:
            content = sha256(np.ascontiguousarray(audio, dtype=np.float32).tobytes())
        else:
            content = sha256(Path(file_path).read_bytes())
        content.update(self._identity.encode("utf-8"))
        return content.hexdigest()

    def _path_for(self, key: str) -> Path:
        return self._root / key[:2] / f"{key}.npz"

    def load(self, file_path: str, *, audio: np.ndarray | None = None) -> EncodedSequence | None:
        """Returns the cached encoding or None on miss/corruption."""
        path = self._path_for(self._key(file_path, audio))
        if not path.exists():
            return None
        try:
            with np.load(path) as payload:
                return EncodedSequence(
                    embeddings=payload["embeddings"].astype(np.float32),
                    frame_start_seconds=payload["frame_start_seconds"].astype(np.float64),
                    frame_end_seconds=payload["frame_end_seconds"].astype(np.float64),
                    backend_id=str(payload["backend_id"]),
                )
        except Exception as err:  # noqa: BLE001 - ANY corruption (BadZipFile,
            # zlib.error, EOFError...) reads as a miss; crashing training on a
            # truncated cache entry defeats the cache's purpose. Disposition
            # RECOMPUTE per the failure taxonomy (training_readiness.classify_failure).
            from ser_tpu_torch._internal.models.training_readiness import (
                CacheEntryCorruptError,
                FailureScope,
                classify_failure,
            )

            classification = classify_failure(
                CacheEntryCorruptError(str(err)), scope=FailureScope.CACHE
            )
            logger.warning(
                "Dropping corrupt embedding-cache entry %s (%s -> %s): %s",
                path,
                classification.reason_code.value,
                classification.disposition.value,
                err,
            )
            try:
                path.unlink()
            except OSError:
                pass
            return None

    def store(
        self, file_path: str, encoded: EncodedSequence, *, audio: np.ndarray | None = None
    ) -> Path:
        """Persists one encoding; atomic via temp-file rename."""
        import os

        path = self._path_for(self._key(file_path, audio))
        path.parent.mkdir(parents=True, exist_ok=True)
        # Unique per-writer temp name: concurrent same-clip stores sharing a
        # deterministic temp path interleaved zip bytes and could rename a
        # corrupt entry into place.
        tmp = path.with_suffix(f".tmp.{os.getpid()}.npz")
        try:
            np.savez_compressed(
                tmp,
                embeddings=encoded.embeddings,
                frame_start_seconds=encoded.frame_start_seconds,
                frame_end_seconds=encoded.frame_end_seconds,
                backend_id=np.asarray(encoded.backend_id),
            )
            tmp.replace(path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        return path


__all__ = ["EmbeddingCache"]
