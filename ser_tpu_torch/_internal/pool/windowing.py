"""Deterministic temporal pooling-window generation.

Parity surface: reference ``ser/_internal/pool/windowing.py:10-71`` — clip-wide
window when the clip is shorter than the window size, stride-spaced windows
otherwise, and a tail window completing coverage of the clip end.
"""

from __future__ import annotations

import numpy as np

from ser_tpu_torch._internal.repr import EncodedSequence, PoolingWindow


def temporal_pooling_windows(
    encoded: EncodedSequence,
    *,
    window_size_seconds: float,
    window_stride_seconds: float,
) -> list[PoolingWindow]:
    """Builds ordered pooling windows covering the encoded timeline."""
    if window_size_seconds <= 0.0 or not np.isfinite(window_size_seconds):
        raise ValueError("window_size_seconds must be a positive finite float.")
    if window_stride_seconds <= 0.0 or not np.isfinite(window_stride_seconds):
        raise ValueError("window_stride_seconds must be a positive finite float.")

    clip_start = float(encoded.frame_start_seconds[0])
    clip_end = float(encoded.frame_end_seconds[-1])
    clip_duration = clip_end - clip_start
    if clip_duration <= 0.0:
        raise ValueError("Encoded sequence duration must be positive.")

    effective_window = min(window_size_seconds, clip_duration)
    if np.isclose(effective_window, clip_duration):
        return [PoolingWindow(start_seconds=clip_start, end_seconds=clip_end)]

    # Vectorized window plan over SEQUENTIALLY-ACCUMULATED cursors:
    # np.cumsum reproduces the reference's `cursor += stride` float sequence
    # bit for bit, where `stride * arange(n)` does not (non-dyadic strides
    # like 0.1 s round differently per element, shifting serialized window
    # timestamps and — on long clips — the fitting count itself).
    epsilon = 1e-9
    estimate = int(
        np.floor((clip_end + epsilon - effective_window - clip_start) / window_stride_seconds)
    ) + 1
    starts = np.empty(0)
    if estimate > 0:
        count = estimate + 2  # fp-drift margin over the closed-form estimate
        while True:
            cursors = np.cumsum(
                np.concatenate(([clip_start], np.full(count, window_stride_seconds)))
            )
            keep = cursors + effective_window <= clip_end + epsilon
            if not keep[-1]:
                starts = cursors[keep]
                break
            count *= 2  # estimate fell short of the accumulated drift
    if starts.size == 0:
        return [
            PoolingWindow(
                start_seconds=max(clip_start, clip_end - effective_window),
                end_seconds=clip_end,
            )
        ]
    windows = [
        PoolingWindow(start_seconds=float(s), end_seconds=float(min(clip_end, s + effective_window)))
        for s in starts
    ]

    # Tail completion: add one right-aligned window when coverage stops short
    # and it isn't a duplicate of the last stride window.
    last = windows[-1]
    if last.end_seconds < clip_end - epsilon:
        tail_start = max(clip_start, clip_end - effective_window)
        is_duplicate = np.isclose(last.start_seconds, tail_start) and np.isclose(
            last.end_seconds, clip_end
        )
        if not is_duplicate:
            windows.append(PoolingWindow(start_seconds=tail_start, end_seconds=clip_end))
    return windows


__all__ = ["temporal_pooling_windows"]
