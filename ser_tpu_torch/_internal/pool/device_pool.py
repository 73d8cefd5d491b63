"""Device-side mean+std pooling: the ``SER_DEVICE_POOLING=1`` lane.

Counterpart of ``ser_tpu/_internal/pool/device_pool.py``. With the lane on,
``chunked_encode`` leaves the valid frames on the card as one float32
(T, D) tensor, and pooling fetches only the (W, 2D) result instead of the
frame matrix. The host float64 path (``stats_pool.mean_std_pool``) stays the
default; the semantics are the same (mean and population std, ddof = 0, per
window, with the half-open window/frame overlap).

Numerics, as in the JAX package: float32 products of the (W, T) window mask
with the frames, with a global per-feature shift before squaring
(E[(x−c)²] − (E[x]−c)²), which removes the cancellation of E[x²] − E[x]²
when |mean| ≫ std. The window masks are built on the host in float64 by the
same ``overlap_frame_mask`` the host path uses, so the frame selection is
identical; only the arithmetic moves to float32 on the device (about 1e-6
relative against the host path). The products run in float32 (PyTorch's
default keeps TF32 off for float32 matmuls).
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np
import torch

from ser_tpu_torch._internal.repr import EncodedSequence, PoolingWindow, overlap_frame_mask

__all__ = ["device_mean_std_pool", "device_pooling_enabled", "is_device_embeddings"]


def device_pooling_enabled() -> bool:
    """True when the opt-in device pooling lane is requested."""
    return os.environ.get("SER_DEVICE_POOLING", "") == "1"


def is_device_embeddings(embeddings) -> bool:
    """True for embeddings held as a tensor (on the card, or the CPU when asked for), not host numpy."""
    return isinstance(embeddings, torch.Tensor)


def _masked_mean_std(embeddings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(T, D) embeddings + (W, T) bool mask → (W, 2D) mean|std rows, float32."""
    emb = embeddings.to(torch.float32)
    weights = mask.to(torch.float32)
    counts = torch.clamp(weights.sum(dim=1, keepdim=True), min=1.0)
    center = emb.mean(dim=0, keepdim=True)
    shifted = emb - center
    mean_shifted = (weights @ shifted) / counts
    sumsq = weights @ (shifted * shifted)
    variance = torch.clamp(sumsq / counts - mean_shifted * mean_shifted, min=0.0)
    return torch.cat([mean_shifted + center, torch.sqrt(variance)], dim=1)


def device_mean_std_pool(encoded: EncodedSequence, windows: Sequence[PoolingWindow]) -> np.ndarray:
    """Pools tensor embeddings per window where they lie; fetches only (W, 2D) as float64.

    Frame selection runs through the same host ``overlap_frame_mask`` as the
    host path (with its outside-range and empty-window checks).
    """
    feature_dim = int(encoded.embeddings.shape[1])
    if not windows:
        return np.empty((0, feature_dim * 2), dtype=np.float64)
    mask = torch.from_numpy(np.stack([overlap_frame_mask(encoded, w) for w in windows]))
    pooled = _masked_mean_std(encoded.embeddings, mask.to(encoded.embeddings.device))
    return pooled.cpu().numpy().astype(np.float64)
