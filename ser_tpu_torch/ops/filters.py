"""Host-side filterbank and window constructors (numpy, cached).

Copied from ``ser_tpu/ops/filters.py`` (the Whisper frontend's part): the
periodic Hann window and the Slaney mel filterbank with slaney area
normalization, following librosa 0.11's conventions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins: k * sr / n_fft for k in [0, n_fft/2]."""
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)


def hz_to_mel_slaney(frequencies: np.ndarray) -> np.ndarray:
    """Slaney-style Hz→mel: linear below 1 kHz, logarithmic above."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = frequencies >= min_log_hz
    safe = np.where(above, frequencies, min_log_hz)
    return np.where(above, min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    """Slaney-style mel→Hz inverse of :func:`hz_to_mel_slaney`."""
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3.0
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128) -> np.ndarray:
    """Triangular Slaney mel filterbank, area-normalized, shape (n_mels, n_bins)."""
    fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_min = hz_to_mel_slaney(np.array(0.0))
    mel_max = hz_to_mel_slaney(np.array(fmax))
    mel_f = mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization: each filter integrates to ~2 / bandwidth.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm.reshape(-1, 1)
    return weights.astype(np.float32).reshape(n_mels, n_bins)


@lru_cache(maxsize=8)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window of length n (librosa/scipy fftbins=True convention)."""
    if n == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


__all__ = [
    "fft_frequencies",
    "hann_window",
    "hz_to_mel_slaney",
    "mel_filterbank",
    "mel_to_hz_slaney",
]
