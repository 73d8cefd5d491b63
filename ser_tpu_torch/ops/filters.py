"""Host-side filterbank, window and transform constructors (numpy, cached).

Copied from ``ser_tpu/ops/filters.py``: the periodic Hann window and the
Slaney mel filterbank with slaney area normalization (the Whisper front end
and the fast profile), and the fast profile's orthonormal DCT-II, chroma,
spectral-contrast band, pseudo-CQT and tonnetz constants, following librosa
0.11's conventions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

A440_OCT_REF = 27.5  # A440 / 16, the hz_to_octs reference frequency


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
def dct_ii_ortho(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in): MFCC = dct @ log_mel."""
    k = np.arange(n_out, dtype=np.float64).reshape(-1, 1)
    n = np.arange(n_in, dtype=np.float64).reshape(1, -1)
    basis = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis.astype(np.float32)


@lru_cache(maxsize=32)
def chroma_base_bins(sr: int, n_fft: int, n_chroma: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Static pieces of the chroma filterbank that are independent of tuning.

    Returns ``(frqbins0, binwidthbins)`` where the tuning-dependent filterbank is
    built on the device as a function of ``frqbins = frqbins0 - tuning`` (a uniform
    shift, which leaves bin widths unchanged).
    """
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * np.log2(frequencies / A440_OCT_REF)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    return frqbins.astype(np.float64), binwidthbins.astype(np.float64)


@lru_cache(maxsize=32)
def contrast_band_slices(sr: int, n_fft: int, fmin: float = 200.0, n_bands: int = 6):
    """Per-band rFFT bin index ranges for spectral contrast (librosa band logic).

    Returns a tuple of ``(start, stop, quantile_count)`` per band where
    ``S[start:stop]`` is the sub-band (already excluding the last bin for
    non-final bands) and ``quantile_count`` is the number of sorted bins
    averaged into the valley/peak estimates.
    """
    quantile = 0.02
    freq = fft_frequencies(sr, n_fft)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    slices = []
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        current_band = np.logical_and(freq >= f_low, freq <= f_high)
        idx = np.flatnonzero(current_band)
        if idx.size == 0:
            raise ValueError(
                f"Spectral contrast band {k} is empty for sr={sr}, n_fft={n_fft}."
            )
        start, stop = int(idx[0]), int(idx[-1]) + 1
        if k > 0:
            start -= 1
        if k == n_bands:
            stop = len(freq)
        band_size = stop - start
        if k < n_bands:
            stop -= 1  # sub_band drops its last bin for non-final bands
        n_quant = int(max(np.rint(quantile * band_size), 1))
        slices.append((start, stop, n_quant))
    return tuple(slices)


@lru_cache(maxsize=32)
def log_frequency_filterbank(
    sr: int,
    n_fft: int,
    bins_per_octave: int = 36,
    n_octaves: int = 7,
    fmin: float = 32.70319566257483,  # C1
) -> np.ndarray:
    """Pseudo-CQT projection filterbank, shape (n_octaves*bins_per_octave, n_bins).

    Design note: librosa's tonnetz path runs a true recursive CQT. Here the
    CQT is approximated by projecting the rFFT magnitude onto constant-Q
    Gaussian bands, one matrix product, at a small numerical deviation for
    the 6 tonnetz dims of the 193-dim feature vector.
    """
    n_bins_cq = bins_per_octave * n_octaves
    fftfreqs = fft_frequencies(sr, n_fft)
    center = fmin * 2.0 ** (np.arange(n_bins_cq) / bins_per_octave)
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    sigma = center / q / 2.0  # Gaussian std ~ half the constant-Q bandwidth
    weights = np.exp(
        -0.5 * ((fftfreqs.reshape(1, -1) - center.reshape(-1, 1)) / sigma.reshape(-1, 1)) ** 2
    )
    norms = weights.sum(axis=1, keepdims=True)
    weights = weights / np.maximum(norms, 1e-12)
    # Bands above Nyquist have no support; leave them zero.
    weights[center >= sr / 2.0] = 0.0
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def cq_to_chroma_fold(bins_per_octave: int = 36, n_octaves: int = 7, n_chroma: int = 12) -> np.ndarray:
    """Aggregation matrix folding CQT bins onto chroma classes, shape (n_chroma, n_cq).

    Bins are assigned round-robin to chroma classes then rolled so class 0 is C
    (CQT fmin is C1, so no roll offset is needed beyond merge).
    """
    n_bins_cq = bins_per_octave * n_octaves
    merge = bins_per_octave // n_chroma
    fold = np.zeros((n_chroma, n_bins_cq), dtype=np.float32)
    for b in range(n_bins_cq):
        fold[(b // merge) % n_chroma, b] = 1.0
    return fold


def tonnetz_transform(n_chroma: int = 12) -> np.ndarray:
    """Tonal-centroid transform phi, shape (6, n_chroma) (librosa tonnetz basis)."""
    dim_map = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    v = np.multiply.outer(scale, dim_map)
    v[::2] -= 0.5
    r = np.array([1.0, 1.0, 1.0, 1.0, 0.5, 0.5])
    return (r.reshape(-1, 1) * np.cos(np.pi * v)).astype(np.float32)


@lru_cache(maxsize=8)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window of length n (librosa/scipy fftbins=True convention)."""
    if n == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


__all__ = [
    "A440_OCT_REF",
    "chroma_base_bins",
    "contrast_band_slices",
    "cq_to_chroma_fold",
    "dct_ii_ortho",
    "fft_frequencies",
    "hann_window",
    "hz_to_mel_slaney",
    "log_frequency_filterbank",
    "mel_filterbank",
    "mel_to_hz_slaney",
    "tonnetz_transform",
]
