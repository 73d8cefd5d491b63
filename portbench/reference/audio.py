"""Plain reference of the read: a 16-bit PCM WAV file to peak-normalized samples at 16 kHz.

What a WAV reader does by its format: samples over 32768, channels averaged, the peak
scaled to 1, then polyphase resampling (scipy's ``resample_poly``, its default Kaiser
filter) to the encoders' 16 kHz, all in float64.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """(float64 mono samples in [-1, 1], sample rate) of a 16-bit PCM WAV file."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    pos, fmt, payload = 12, None, None
    while pos + 8 <= len(data):
        chunk, size = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if chunk == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", data, pos + 8)
        elif chunk == b"data":
            payload = data[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None or fmt[0] != 1 or fmt[5] != 16:
        raise ValueError(f"{path} is not 16-bit PCM")
    channels, rate = fmt[1], fmt[2]
    samples = np.frombuffer(payload, dtype="<i2").astype(np.float64) / 32768.0
    mono = samples.reshape(-1, channels).mean(axis=1)
    peak = np.abs(mono).max()
    return (mono / peak if peak > 0 else mono), rate


def to_16k(samples: np.ndarray, rate: int) -> np.ndarray:
    """``samples`` resampled to 16 kHz, float64."""
    if rate == SAMPLE_RATE:
        return samples
    from scipy.signal import resample_poly

    g = math.gcd(rate, SAMPLE_RATE)
    return resample_poly(samples, SAMPLE_RATE // g, rate // g)
