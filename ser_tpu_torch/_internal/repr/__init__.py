"""Feature/representation backends (encode → pool contract)."""

from ser_tpu_torch._internal.repr.backend import (
    EncodedSequence,
    FeatureBackend,
    PoolingWindow,
    overlap_frame_mask,
)

__all__ = [
    "EncodedSequence",
    "FeatureBackend",
    "PoolingWindow",
    "overlap_frame_mask",
]
