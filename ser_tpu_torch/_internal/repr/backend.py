"""Typed backend contracts for representation encoding and pooling.

Parity surface: reference ``ser/_internal/repr/backend.py:19-156`` — identical
invariants for ``EncodedSequence`` (2D embeddings, matching monotone timestamp
vectors, finite everywhere) and the window-overlap mask semantics used by every
pooling path.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
from numpy.typing import NDArray

type EmbeddingMatrix = NDArray[np.float32]
type TimeVector = NDArray[np.float64]
type FeatureMatrix = NDArray[np.float64]
type FeatureVector = NDArray[np.float64]
type WindowMask = NDArray[np.bool_]


@dataclass(frozen=True)
class PoolingWindow:
    """Temporal window used when pooling encoded frame features."""

    start_seconds: float
    end_seconds: float

    def __post_init__(self) -> None:
        if not np.isfinite(self.start_seconds) or not np.isfinite(self.end_seconds):
            raise ValueError("PoolingWindow bounds must be finite numbers.")
        if self.start_seconds < 0.0:
            raise ValueError("PoolingWindow start_seconds must be non-negative.")
        if self.end_seconds <= self.start_seconds:
            raise ValueError("PoolingWindow end_seconds must be greater than start_seconds.")


@dataclass(frozen=True)
class EncodedSequence:
    """Frame-level encoded representation with explicit temporal boundaries."""

    embeddings: EmbeddingMatrix
    frame_start_seconds: TimeVector
    frame_end_seconds: TimeVector
    backend_id: str

    def __post_init__(self) -> None:
        frame_count = int(self.embeddings.shape[0]) if self.embeddings.ndim == 2 else 0
        invariants: tuple[tuple[bool, str], ...] = (
            (bool(self.backend_id), "backend_id must be a non-empty string."),
            (self.embeddings.ndim == 2, "embeddings must be 2D (frames, features)."),
            (
                self.frame_start_seconds.ndim == 1 and self.frame_end_seconds.ndim == 1,
                "frame timestamp arrays must be 1D.",
            ),
            (frame_count > 0, "must contain at least one frame."),
            (
                self.frame_start_seconds.size == frame_count
                and self.frame_end_seconds.size == frame_count,
                "timestamp lengths must match the embeddings frame count.",
            ),
        )
        for holds, message in invariants:
            if not holds:
                raise ValueError(f"EncodedSequence {message}")
        for name, array in (
            ("embeddings", self.embeddings),
            ("frame_start_seconds", self.frame_start_seconds),
            ("frame_end_seconds", self.frame_end_seconds),
        ):
            if not isinstance(array, np.ndarray):
                # Embeddings left on the device (the SER_DEVICE_POOLING lane):
                # the encode that made them ran the finite check on the
                # device (chunked_encode); a second check here would fetch them.
                continue
            if not np.all(np.isfinite(array)):
                raise ValueError(f"EncodedSequence {name} contain non-finite values.")
        for name, times in (
            ("frame_start_seconds", self.frame_start_seconds),
            ("frame_end_seconds", self.frame_end_seconds),
        ):
            if np.any(np.diff(times) < 0.0):
                raise ValueError(f"{name} must be non-decreasing.")
        if np.any(self.frame_end_seconds <= self.frame_start_seconds):
            raise ValueError("Each frame must satisfy end_seconds > start_seconds.")


def overlap_frame_mask(encoded: EncodedSequence, window: PoolingWindow) -> WindowMask:
    """Returns a mask of frames intersecting the pooling window.

    Raises ``ValueError`` when the window leaves the encoded range or selects
    no frames — pooling on an empty selection would silently produce NaNs.
    """
    window_span = f"[{window.start_seconds}, {window.end_seconds}]"
    encoded_span = (
        float(encoded.frame_start_seconds[0]),
        float(encoded.frame_end_seconds[-1]),
    )
    if window.start_seconds < encoded_span[0] or window.end_seconds > encoded_span[1]:
        raise ValueError(
            f"Pooling window is outside encoded sequence range: {window_span} vs "
            f"[{encoded_span[0]}, {encoded_span[1]}]"
        )
    # Half-open interval intersection: a frame belongs to the window when it
    # ends after the window starts AND starts before the window ends.
    mask = (encoded.frame_end_seconds > window.start_seconds) & (
        encoded.frame_start_seconds < window.end_seconds
    )
    if not np.any(mask):
        raise ValueError(
            f"Pooling window does not overlap any encoded frames: {window_span}"
        )
    return mask


@runtime_checkable
class FeatureBackend(Protocol):
    """Backend protocol for sequence encoding and temporal pooling."""

    @property
    def backend_id(self) -> str:
        """Unique backend identifier persisted for compatibility checks."""
        ...

    @property
    def feature_dim(self) -> int:
        """Feature dimension produced per pooled vector."""
        ...

    def encode_sequence(
        self, audio: NDArray[np.float32], sample_rate: int
    ) -> EncodedSequence:
        """Encodes audio into frame-level representations."""
        ...

    def pool(
        self, encoded: EncodedSequence, windows: Sequence[PoolingWindow]
    ) -> FeatureMatrix:
        """Pools encoded representations over one or more temporal windows."""
        ...


__all__ = [
    "window_mean_pool",
    "EmbeddingMatrix",
    "EncodedSequence",
    "FeatureBackend",
    "FeatureMatrix",
    "FeatureVector",
    "PoolingWindow",
    "TimeVector",
    "WindowMask",
    "overlap_frame_mask",
]


def window_mean_pool(encoded: EncodedSequence, windows) -> np.ndarray:
    """Per-window float64 mean over the frames overlapping each window.

    The one owner of the backend ``pool()`` contract (the three encoder
    backends previously carried identical copies).
    """
    if not windows:
        return np.empty((0, encoded.embeddings.shape[1]), dtype=np.float64)
    rows = [
        np.asarray(
            encoded.embeddings[overlap_frame_mask(encoded, window)], dtype=np.float64
        ).mean(axis=0)
        for window in windows
    ]
    return np.vstack(rows)
