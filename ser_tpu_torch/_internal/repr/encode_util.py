"""Shared clip-encoding helper over the FeatureBackend protocol.

Copied from ``ser_tpu/_internal/repr/encode_util.py``.
"""

from __future__ import annotations

import numpy as np


def encode_clips(backend, clips: list[tuple[np.ndarray, int]]) -> list:
    """Encodes many (audio, sr) clips, batched when the backend supports it.

    One owner for the ``encode_sequences``-if-available dispatch that batch
    inference, encoder training, and the quality gate all need — divergent
    copies drift.
    """
    encode_many = getattr(backend, "encode_sequences", None)
    if callable(encode_many):
        return list(encode_many(clips))
    return [backend.encode_sequence(audio, sr) for audio, sr in clips]


__all__ = ["encode_clips"]
