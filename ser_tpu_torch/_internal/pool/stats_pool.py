"""Statistics pooling over encoded frame sequences.

Parity surface: reference ``ser/_internal/pool/stats_pool.py:15-43`` — mean+std
concatenation per window, float64, population std (ddof=0).

Copied from ``ser_tpu/_internal/pool/stats_pool.py``: embeddings left on the
device by the ``SER_DEVICE_POOLING=1`` encode lane (a tensor) pool there
(``device_pool.py``); host numpy embeddings take the float64 path.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
from numpy.typing import NDArray

from ser_tpu_torch._internal.pool.device_pool import device_mean_std_pool, is_device_embeddings
from ser_tpu_torch._internal.repr import EncodedSequence, PoolingWindow, overlap_frame_mask

type PooledFeatureMatrix = NDArray[np.float64]


def mean_std_pool(
    encoded: EncodedSequence,
    windows: Sequence[PoolingWindow],
) -> PooledFeatureMatrix:
    """Pools encoded frames into per-window mean+std vectors, shape (W, 2*D).

    Host numpy embeddings: float64 arithmetic, bit-identical to ``ser_tpu``'s
    parity path. Tensor embeddings (the ``SER_DEVICE_POOLING=1`` lane) pool
    where they lie and fetch only the (W, 2D) result.
    """
    feature_dim = int(encoded.embeddings.shape[1])
    if not windows:
        return np.empty((0, feature_dim * 2), dtype=np.float64)
    if is_device_embeddings(encoded.embeddings):
        return device_mean_std_pool(encoded, windows)
    rows: list[NDArray[np.float64]] = []
    for window in windows:
        mask = overlap_frame_mask(encoded, window)
        selected = np.asarray(encoded.embeddings[mask], dtype=np.float64)
        rows.append(np.concatenate((selected.mean(axis=0), selected.std(axis=0))))
    return np.vstack(rows).astype(np.float64, copy=False)


__all__ = ["mean_std_pool"]
