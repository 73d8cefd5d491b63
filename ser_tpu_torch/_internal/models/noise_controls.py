"""Window-level label-noise controls for pooled encoder features.

Counterpart of ``ser_tpu/_internal/models/noise_controls.py`` (numpy, run on
the host over pooled rows): a window's score is the RMS of the std half of
its mean+std row; windows under ``min_window_std`` drop, but when every
window of a clip fails the floor its highest-scoring one is kept; the
per-clip cap keeps ``max_windows_per_clip`` windows at evenly spaced
positions; every decision is counted, and the counts merge into the
training report.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NoiseControlStats:
    """Window-filtering counters for training traceability."""

    total_windows: int = 0
    kept_windows: int = 0
    dropped_low_std_windows: int = 0
    dropped_cap_windows: int = 0
    forced_keep_windows: int = 0

    def merged(self, other: "NoiseControlStats") -> "NoiseControlStats":
        return NoiseControlStats(
            total_windows=self.total_windows + other.total_windows,
            kept_windows=self.kept_windows + other.kept_windows,
            dropped_low_std_windows=(
                self.dropped_low_std_windows + other.dropped_low_std_windows
            ),
            dropped_cap_windows=self.dropped_cap_windows + other.dropped_cap_windows,
            forced_keep_windows=self.forced_keep_windows + other.forced_keep_windows,
        )

    def as_dict(self) -> dict[str, int]:
        return {
            "total_windows": self.total_windows,
            "kept_windows": self.kept_windows,
            "dropped_low_std_windows": self.dropped_low_std_windows,
            "dropped_cap_windows": self.dropped_cap_windows,
            "forced_keep_windows": self.forced_keep_windows,
        }


def apply_noise_controls(
    pooled_features: np.ndarray,
    *,
    min_window_std: float,
    max_windows_per_clip: int,
) -> tuple[np.ndarray, np.ndarray, NoiseControlStats]:
    """Filters one clip's pooled windows; returns (kept, kept_indices, stats).

    ``kept_indices`` (into the input rows) is this repo's addition so callers
    can carry parallel per-window payloads (labels, sample ids); the selected
    set is identical to the reference's.
    """
    if pooled_features.ndim != 2 or int(pooled_features.shape[1]) <= 0:
        raise RuntimeError("Pooled features must be a non-empty 2D matrix.")
    total = int(pooled_features.shape[0])
    if total == 0:
        raise RuntimeError("Pooled feature matrix contains zero rows.")
    width = int(pooled_features.shape[1])
    if width % 2 != 0:
        raise RuntimeError("Pooled feature width must be even (mean+std concatenation).")

    std_half = pooled_features[:, width // 2 :]
    std_scores = np.linalg.norm(std_half, axis=1) / np.sqrt(width / 2.0)

    keep_mask = np.ones(total, dtype=np.bool_)
    dropped_low_std = 0
    forced_keep = 0
    if min_window_std > 0.0:
        keep_mask = std_scores >= min_window_std
        if not np.any(keep_mask):
            keep_mask[int(np.argmax(std_scores))] = True
            forced_keep = 1
        dropped_low_std = total - int(np.sum(keep_mask))

    kept_indices = np.flatnonzero(keep_mask)
    dropped_cap = 0
    if max_windows_per_clip > 0 and kept_indices.size > max_windows_per_clip:
        selected = np.linspace(
            0, kept_indices.size - 1, num=max_windows_per_clip, dtype=np.int64
        )
        dropped_cap = int(kept_indices.size) - max_windows_per_clip
        kept_indices = kept_indices[selected]

    kept = np.asarray(pooled_features[kept_indices], dtype=np.float64)
    return (
        kept,
        kept_indices,
        NoiseControlStats(
            total_windows=total,
            kept_windows=int(kept.shape[0]),
            dropped_low_std_windows=dropped_low_std,
            dropped_cap_windows=dropped_cap,
            forced_keep_windows=forced_keep,
        ),
    )


__all__ = ["NoiseControlStats", "apply_noise_controls"]
