"""Batched DSP of the fast profile's handcrafted features, in PyTorch.

Counterpart of ``ser_tpu/ops/dsp.py``, librosa's feature extraction as one
batched program over all frames of a clip, on the frames' device (the card
unless the caller hands CPU tensors):

- frames are zero-padded to one length, and per-frame STFT-column masks
  (``col_mask``, valid columns as a prefix) reproduce librosa's results on
  the shorter true signal;
- the mel, MFCC, chroma, pseudo-CQT and tonnetz projections are float32
  matrix products against the constants of ``ops/filters.py``, with TF32
  off on the card (``_float32_products``): the fast profile's golden
  tolerances (``tests/suites/unit/ops/test_dsp_golden_fixtures.py``) are
  tighter than TF32's 10-bit mantissa;
- chroma tuning (librosa ``estimate_tuning`` / ``piptrack``) runs in the
  batch with masked medians and histograms; a median of an even count
  averages the two middle values, as numpy's does (``torch.median`` would
  return the lower);
- tonnetz applies the HPSS harmonic mask to the low band of the same STFT
  and a pseudo-CQT projection, as the JAX package does (not librosa's
  istft + CQT round trip).

The STFT is ``torch.fft.rfft`` (cuFFT on the card, pocketfft on the CPU),
XLA's FFT in the JAX package: float32 results differ in the last bits, which
the tests hold at the golden tolerances. Every function takes and returns
float32 tensors; the host boundary widens to float64.
"""

from __future__ import annotations

from collections.abc import Callable
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from ser_tpu_torch.ops import filters

_AMIN = 1e-10
_TOP_DB = 80.0
_TINY = float(np.finfo(np.float32).tiny)


@lru_cache(maxsize=64)
def _on_device(build: Callable[..., np.ndarray], args: tuple, device: torch.device) -> torch.Tensor:
    """``build(*args)`` as a float32 tensor on ``device``, copied there once."""
    return torch.as_tensor(np.asarray(build(*args)), dtype=torch.float32, device=device)


@contextmanager
def _float32_products(device: torch.device):
    """Keeps float32 matrix products on the card in float32 (no TF32) for the duration."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


# --------------------------------------------------------------------------- #
# STFT
# --------------------------------------------------------------------------- #


def stft_magnitude(frames: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Magnitude STFT of batched signals, librosa conventions.

    center=True with zero padding, periodic Hann window of length ``n_fft``.
    ``(B, L)`` → ``(B, 1 + n_fft // 2, 1 + L // hop)``.
    """
    pad = n_fft // 2
    padded = torch.nn.functional.pad(frames, (pad, pad))
    windows = padded.unfold(-1, n_fft, hop_length)  # (B, 1 + L // hop, n_fft)
    window = _on_device(filters.hann_window, (n_fft,), frames.device)
    spec = torch.fft.rfft(windows * window, n=n_fft, dim=-1)
    return spec.abs().transpose(1, 2).to(torch.float32)


# --------------------------------------------------------------------------- #
# Shared helpers
# --------------------------------------------------------------------------- #


def masked_mean_cols(values: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the trailing column axis, valid columns only: (B, D, T), (B, T) → (B, D)."""
    mask = col_mask[:, None, :].to(values.dtype)
    count = torch.clamp(mask.sum(dim=-1), min=1.0)
    return (values * mask).sum(dim=-1) / count


def _masked_max(values: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """Max over (bins, cols), valid columns only: (B, F, T) → (B,)."""
    lowest = torch.finfo(values.dtype).min
    return torch.where(col_mask[:, None, :], values, lowest).amax(dim=(-2, -1))


def power_to_db(power: torch.Tensor, col_mask: torch.Tensor, *, ref: torch.Tensor | float = 1.0) -> torch.Tensor:
    """librosa ``power_to_db`` with a per-frame masked ``top_db`` clamp.

    power: (B, F, T); ref: a scalar or a (B,) per-frame reference. As in
    librosa, a real input is not made absolute: negatives clamp to ``amin``
    (the reference's spectral contrast feeds dB values in here, and
    collapses to zero: the JAX package keeps that quirk, and so does this).
    """
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=_AMIN))
    if isinstance(ref, torch.Tensor):
        log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref.abs(), min=_AMIN))[:, None, None]
    else:
        log_spec = log_spec - 10.0 * float(np.log10(max(_AMIN, abs(ref))))
    peak = _masked_max(log_spec, col_mask)
    return torch.maximum(log_spec, (peak - _TOP_DB)[:, None, None])


def power_to_db_ref_max(power: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """librosa ``power_to_db(S, ref=np.max)``, the max over valid columns.

    The clip to ``[-top_db, 0]`` is ref=max's exact semantics: the maximum
    lands on exactly 0, whatever order the reductions take.
    """
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=_AMIN))
    peak = _masked_max(log_spec, col_mask)
    return torch.clamp(log_spec - peak[:, None, None], -_TOP_DB, 0.0)


# --------------------------------------------------------------------------- #
# MFCC + mel
# --------------------------------------------------------------------------- #


def mel_power(mag: torch.Tensor, sr: int, n_fft: int, n_mels: int = 128) -> torch.Tensor:
    """Mel power spectrogram, mel_fb @ mag²: (B, F, T) → (B, n_mels, T)."""
    fb = _on_device(filters.mel_filterbank, (sr, n_fft, n_mels), mag.device)
    with _float32_products(mag.device):
        return torch.matmul(fb, mag * mag)


def mfcc_per_column(mel_pow: torch.Tensor, col_mask: torch.Tensor, n_mfcc: int = 40) -> torch.Tensor:
    """Per-column MFCCs from the mel power spectrogram: (B, M, T) → (B, n_mfcc, T)."""
    log_mel = power_to_db(mel_pow, col_mask, ref=1.0)
    dct = _on_device(filters.dct_ii_ortho, (n_mfcc, mel_pow.shape[1]), mel_pow.device)
    with _float32_products(mel_pow.device):
        return torch.matmul(dct, log_mel)


# --------------------------------------------------------------------------- #
# Chroma (with tuning estimation)
# --------------------------------------------------------------------------- #


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise median of ``values`` where ``mask`` holds; 0 for an empty row.

    values, mask: (B, N) → (B,). numpy's semantics: an even count averages
    the two middle order statistics.
    """
    count = mask.sum(dim=-1)
    ordered = torch.sort(torch.where(mask, values, torch.inf), dim=-1).values
    last = values.shape[-1] - 1
    lo = torch.clamp((count - 1) // 2, 0, last)
    hi = torch.clamp(count // 2, 0, last)
    median = 0.5 * (ordered.gather(-1, lo[:, None]) + ordered.gather(-1, hi[:, None]))[:, 0]
    return torch.where(count > 0, median, torch.zeros_like(median))


def _local_max_bins(spec: torch.Tensor) -> torch.Tensor:
    """librosa ``util.localmax`` along the frequency axis (1) with edge padding."""
    prev = torch.cat([spec[:, :1], spec[:, :-1]], dim=1)
    nxt = torch.cat([spec[:, 1:], spec[:, -1:]], dim=1)
    return (spec > prev) & (spec >= nxt)


def estimate_tuning(
    mag: torch.Tensor,
    col_mask: torch.Tensor,
    sr: int,
    n_fft: int,
    *,
    bins_per_octave: int = 12,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    resolution: float = 0.01,
) -> torch.Tensor:
    """Per-frame tuning deviation in fractional chroma bins (librosa semantics).

    mag: (B, F, T); col_mask: (B, T) → (B,) in [-0.5, 0.5). ``piptrack``
    (parabolic interpolation around spectral local maxima above a tenth of
    the column's peak) and ``pitch_tuning`` (the mode of a 0.01-bin histogram
    of the residuals of the pitches at or above their median magnitude).
    """
    batch, n_bins, _ = mag.shape
    device = mag.device
    fft_freqs = _on_device(filters.fft_frequencies, (sr, n_fft), device)
    freq_sel = (fft_freqs >= fmin) & (fft_freqs < min(fmax, sr / 2.0))

    avg = 0.5 * (mag[:, 2:] - mag[:, :-2])
    denom = 2.0 * mag[:, 1:-1] - mag[:, 2:] - mag[:, :-2]
    shift = avg / (denom + (denom.abs() < _TINY).to(mag.dtype))
    avg = torch.nn.functional.pad(avg, (0, 0, 1, 1))
    shift = torch.nn.functional.pad(shift, (0, 0, 1, 1))
    dskew = 0.5 * avg * shift

    ref_value = threshold * mag.amax(dim=1, keepdim=True)
    candidate = _local_max_bins(mag * (mag > ref_value)) & freq_sel[None, :, None] & col_mask[:, None, :]
    bin_idx = torch.arange(n_bins, dtype=mag.dtype, device=device)[None, :, None]
    pitches = torch.where(candidate, (bin_idx + shift) * (sr / n_fft), 0.0).reshape(batch, -1)
    mags = torch.where(candidate, mag + dskew, 0.0).reshape(batch, -1)

    pitch_mask = pitches > 0.0
    median = masked_median(mags, pitch_mask)
    selected = pitch_mask & (mags >= median[:, None])
    octs = torch.log2(torch.where(selected, pitches, 1.0) / filters.A440_OCT_REF)
    residual = torch.remainder(bins_per_octave * octs, 1.0)
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)
    n_hist = int(np.ceil(1.0 / resolution))
    hist_idx = torch.clamp(torch.floor((residual + 0.5) * n_hist).to(torch.int64), 0, n_hist - 1)
    counts = torch.zeros(batch, n_hist, dtype=mag.dtype, device=device)
    counts.scatter_add_(1, hist_idx, selected.to(mag.dtype))
    tuning = -0.5 + resolution * torch.argmax(counts, dim=1).to(mag.dtype)
    return torch.where(selected.any(dim=1), tuning, 0.0)


def _chroma_frqbins(sr: int, n_fft: int, n_chroma: int) -> np.ndarray:
    return filters.chroma_base_bins(sr, n_fft, n_chroma)[0]


def _chroma_binwidth(sr: int, n_fft: int, n_chroma: int) -> np.ndarray:
    return filters.chroma_base_bins(sr, n_fft, n_chroma)[1]


def chroma_filterbank_for_tuning(
    tuning: torch.Tensor,
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    *,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
) -> torch.Tensor:
    """Per-frame chroma filterbanks for the estimated tunings: (B,) → (B, n_chroma, n_bins).

    librosa ``filters.chroma``: L2-normalized Gaussian profiles, a Gaussian
    octave weighting, rolled so that class 0 is C.
    """
    device = tuning.device
    frqbins0 = _on_device(_chroma_frqbins, (sr, n_fft, n_chroma), device)
    binwidth = _on_device(_chroma_binwidth, (sr, n_fft, n_chroma), device)
    frqbins = frqbins0[None, :] - tuning[:, None]  # (B, n_fft)
    d = frqbins[:, None, :] - torch.arange(n_chroma, dtype=torch.float32, device=device)[None, :, None]
    half = round(n_chroma / 2.0)
    d = torch.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = torch.exp(-0.5 * (2.0 * d / binwidth[None, None, :]) ** 2)
    norms = torch.sqrt((wts * wts).sum(dim=1, keepdim=True))
    wts = wts / torch.where(norms < _TINY, 1.0, norms)
    wts = wts * torch.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2))[:, None, :]
    wts = torch.roll(wts, -3 * (n_chroma // 12), dims=1)
    return wts[:, :, : 1 + n_fft // 2]


def chroma_per_column(
    mag: torch.Tensor, col_mask: torch.Tensor, sr: int, n_fft: int, n_chroma: int = 12
) -> torch.Tensor:
    """Per-column chroma of a magnitude STFT, tuning estimated per frame.

    librosa ``chroma_stft(S=magnitude)``: the magnitude (power 1) feeds the
    projection, and each column is inf-norm normalized.
    """
    tuning = estimate_tuning(mag, col_mask, sr, n_fft, bins_per_octave=n_chroma)
    fb = chroma_filterbank_for_tuning(tuning, sr, n_fft, n_chroma)
    with _float32_products(mag.device):
        raw = torch.bmm(fb, mag)
    denom = raw.abs().amax(dim=1, keepdim=True)
    return raw / torch.where(denom < _TINY, 1.0, denom)


# --------------------------------------------------------------------------- #
# Spectral contrast
# --------------------------------------------------------------------------- #


def spectral_contrast_per_column(s_db: torch.Tensor, col_mask: torch.Tensor, sr: int, n_fft: int) -> torch.Tensor:
    """Per-column spectral contrast (7 bands) over a dB spectrogram.

    The reference feeds ``power_to_db(mag², ref=max)`` as S, so the band's
    valley and peak order statistics run on dB values, and the contrast is
    ``power_to_db(peak) - power_to_db(valley)`` (librosa ``linear=False``).
    """
    valleys, peaks = [], []
    for start, stop, n_quant in filters.contrast_band_slices(sr, n_fft):
        sub = torch.sort(s_db[:, start:stop, :], dim=1).values
        valleys.append(sub[:, :n_quant, :].mean(dim=1))
        peaks.append(sub[:, -n_quant:, :].mean(dim=1))
    valley = torch.stack(valleys, dim=1)
    peak = torch.stack(peaks, dim=1)
    return power_to_db(peak, col_mask, ref=1.0) - power_to_db(valley, col_mask, ref=1.0)


# --------------------------------------------------------------------------- #
# Tonnetz (HPSS mask + pseudo-CQT chroma + tonal centroid transform)
# --------------------------------------------------------------------------- #


def _symmetric_index(n: int, half: int, device: torch.device) -> torch.Tensor:
    """Indices of numpy's ``"symmetric"`` padding by ``half`` on each side of ``n`` (edge repeated)."""
    idx = torch.remainder(torch.arange(-half, n + half, device=device), 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def median_filter_axis(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """Running median of odd ``width`` along ``dim``, scipy.ndimage's ``"reflect"`` edges.

    The middle of an odd count: ``torch.median``'s lower median is exact here.
    """
    half = width // 2
    moved = x.movedim(dim, -1)
    padded = moved.index_select(-1, _symmetric_index(moved.shape[-1], half, x.device))
    return padded.unfold(-1, width, 1).median(dim=-1).values.movedim(-1, dim)


def median_filter_time_clamped(x: torch.Tensor, width: int, col_mask: torch.Tensor) -> torch.Tensor:
    """Running median along time whose windows never read masked columns.

    x: (B, F, T); col_mask: (B, T), valid columns a prefix. Window indices
    clamp to ``[0, valid - 1]`` per row (edge replication at the true signal
    end), so the result does not depend on how far the frame was padded.
    """
    half = width // 2
    batch, _, n_cols = x.shape
    valid = torch.clamp(col_mask.sum(dim=-1), min=1)
    offsets = torch.arange(-half, half + 1, device=x.device)
    idx = torch.arange(n_cols, device=x.device)[None, :, None] + offsets[None, None, :]  # (1, T, W)
    idx = torch.minimum(torch.clamp(idx, min=0), (valid - 1)[:, None, None])  # (B, T, W)
    rows = torch.arange(batch, device=x.device)[:, None, None]
    gathered = x.transpose(1, 2)[rows, idx]  # (B, T, W, F)
    return gathered.median(dim=2).values.transpose(1, 2)


def harmonic_mask(
    mag: torch.Tensor,
    kernel_size: int = 31,
    power: float = 2.0,
    col_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft harmonic HPSS mask of a magnitude spectrogram (B, F, T).

    librosa ``decompose.hpss`` with margin 1: median enhancement along time
    (harmonic) and frequency (percussive), then a power-2 soft mask. With
    ``col_mask``, the time median respects the true signal length.
    """
    if col_mask is not None:
        harm = median_filter_time_clamped(mag, kernel_size, col_mask)
    else:
        harm = median_filter_axis(mag, kernel_size, dim=-1)
    perc = median_filter_axis(mag, kernel_size, dim=-2)
    z = torch.maximum(harm, perc)
    bad = z < _TINY
    z = torch.where(bad, 1.0, z)
    hp = (harm / z) ** power
    pp = (perc / z) ** power
    return torch.where(bad, 0.0, hp / (hp + pp + _TINY))


def _tonnetz_chroma_filterbank(sr: int, n_fft: int, n_bins_keep: int) -> np.ndarray:
    return filters.cq_to_chroma_fold() @ filters.log_frequency_filterbank(sr, n_fft)[:, :n_bins_keep]


def tonnetz_per_column(
    mag: torch.Tensor,
    sr: int,
    n_fft: int,
    *,
    lowband_hz: float = 5500.0,
    col_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-column tonal centroid features (6 dims) from the shared STFT.

    The HPSS harmonic mask applies to the STFT's low band (the pseudo-CQT has
    no support above about C8), a constant-Q projection folded to chroma
    follows, then the L1-normalized chroma's tonal centroid.
    """
    n_bins_keep = min(mag.shape[1], int(lowband_hz / (sr / n_fft)) + 16)
    low = mag[:, :n_bins_keep, :]
    harmonic = low * harmonic_mask(low, col_mask=col_mask)
    chroma_fb = _on_device(_tonnetz_chroma_filterbank, (sr, n_fft, n_bins_keep), mag.device)
    phi = _on_device(filters.tonnetz_transform, (), mag.device)
    with _float32_products(mag.device):
        chroma = torch.matmul(chroma_fb, harmonic)
        denom = chroma.abs().sum(dim=1, keepdim=True)
        chroma = chroma / torch.where(denom < _TINY, 1.0, denom)
        return torch.matmul(phi, chroma)


# --------------------------------------------------------------------------- #
# The handcrafted feature program
# --------------------------------------------------------------------------- #


def handcrafted_features_batch(
    frames: torch.Tensor,
    frame_lengths: torch.Tensor,
    *,
    sr: int,
    n_fft: int = 2048,
    hop_length: int = 512,
    mfcc: bool = True,
    chroma: bool = True,
    mel: bool = True,
    contrast: bool = True,
    tonnetz: bool = True,
) -> torch.Tensor:
    """Full handcrafted feature vectors of a batch of equal-length frames.

    frames: (B, L) zero-padded float32 signals; frame_lengths: (B,) true
    sample counts. Returns (B, D), D = 40·mfcc + 12·chroma + 128·mel +
    7·contrast + 6·tonnetz, in the reference's order.
    """
    mag = stft_magnitude(frames, n_fft, hop_length)
    n_cols = mag.shape[-1]
    valid_cols = 1 + frame_lengths // hop_length
    col_mask = torch.arange(n_cols, device=frames.device)[None, :] < valid_cols[:, None]

    parts = []
    mel_pow = mel_power(mag, sr, n_fft) if (mfcc or mel) else None
    if mfcc:
        parts.append(masked_mean_cols(mfcc_per_column(mel_pow, col_mask), col_mask))
    if chroma:
        parts.append(masked_mean_cols(chroma_per_column(mag, col_mask, sr, n_fft), col_mask))
    if mel:
        parts.append(masked_mean_cols(mel_pow, col_mask))
    if contrast:
        s_db = power_to_db_ref_max(mag * mag, col_mask)
        parts.append(masked_mean_cols(spectral_contrast_per_column(s_db, col_mask, sr, n_fft), col_mask))
    if tonnetz:
        parts.append(masked_mean_cols(tonnetz_per_column(mag, sr, n_fft, col_mask=col_mask), col_mask))
    if not parts:
        return torch.zeros(frames.shape[0], 0, dtype=torch.float32, device=frames.device)
    return torch.cat(parts, dim=-1)


def handcrafted_features_clip(
    clip: torch.Tensor,
    starts: torch.Tensor,
    frame_lengths: torch.Tensor,
    *,
    frame_length: int,
    sr: int,
    **kwargs,
) -> torch.Tensor:
    """Frames gathered from one clip on its device, then :func:`handcrafted_features_batch`.

    clip: (L,) signal; starts, frame_lengths: (B,) sample offsets and true
    lengths. The overlapping frame matrix (3 s frames at a 1 s stride) is
    three times the clip's bytes: built where the clip lies, it crosses no
    host link. Each row equals the host-framed path's zero-padded frame.
    """
    offsets = torch.arange(frame_length, device=clip.device)
    idx = torch.clamp(starts[:, None] + offsets[None, :], max=clip.shape[0] - 1)
    frames = torch.where(offsets[None, :] < frame_lengths[:, None], clip[idx], 0.0)
    return handcrafted_features_batch(frames, frame_lengths, sr=sr, **kwargs)


__all__ = [
    "chroma_filterbank_for_tuning",
    "chroma_per_column",
    "estimate_tuning",
    "handcrafted_features_batch",
    "handcrafted_features_clip",
    "harmonic_mask",
    "masked_mean_cols",
    "masked_median",
    "median_filter_axis",
    "median_filter_time_clamped",
    "mel_power",
    "mfcc_per_column",
    "power_to_db",
    "power_to_db_ref_max",
    "spectral_contrast_per_column",
    "stft_magnitude",
    "tonnetz_per_column",
]
