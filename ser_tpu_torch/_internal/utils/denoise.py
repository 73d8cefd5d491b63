"""Spectral-gating denoise for the transcription lane.

Counterpart of ``ser_tpu/_internal/utils/denoise.py``: estimate a
per-frequency noise floor from the quietest frames, then softly attenuate the
time-frequency cells near it. Host numpy, once per file before chunking; it
shares the STFT/overlap-add of ``source_separation``.
"""

from __future__ import annotations

import numpy as np

from ser_tpu_torch._internal.utils.source_separation import _istft, _stft

_EPS = 1e-10


def spectral_gate_denoise(
    audio: np.ndarray,
    *,
    n_fft: int = 1024,
    hop: int = 256,
    noise_quantile: float = 0.10,
    threshold_db: float = 6.0,
    transition_db: float = 6.0,
    max_attenuation: float = 0.05,
) -> np.ndarray:
    """Attenuates stationary background noise, preserving speech energy.

    Args:
      audio: mono float32 samples.
      noise_quantile: fraction of lowest-energy frames that define the
        per-frequency noise floor.
      threshold_db: cells within this margin above the floor are gated.
      transition_db: width of the soft sigmoid transition around the gate.
      max_attenuation: residual gain applied to fully gated cells (a hard
        zero rings; a floor keeps the result natural).
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size < n_fft * 2:
        return audio
    # Shared STFT/WOLA core (source_separation._stft/_istft): one framing
    # convention — periodic hann, reflect pad, win²-normalized overlap-add —
    # for both denoise stages of the transcription audio path.
    spectrum = _stft(audio, n_fft, hop)
    magnitude = np.abs(spectrum)

    frame_energy = magnitude.sum(axis=1)
    n_noise = max(2, int(spectrum.shape[0] * noise_quantile))
    quiet = np.argsort(frame_energy)[:n_noise]
    noise_floor_db = 20.0 * np.log10(magnitude[quiet].mean(axis=0) + _EPS)

    cell_db = 20.0 * np.log10(magnitude + _EPS)
    above = cell_db - (noise_floor_db[None, :] + threshold_db)
    # Clip the sigmoid argument: digitally-silent cells sit ~140 dB below
    # the floor, and exp(97) overflows float32 with a RuntimeWarning per
    # file (the gain saturates identically either way).
    z = np.clip(-above / max(transition_db / 4.0, 1e-3), -60.0, 60.0)
    gain = 1.0 / (1.0 + np.exp(z))
    gain = max_attenuation + (1.0 - max_attenuation) * gain
    gated = spectrum * gain
    return _istft(gated, n_fft, hop, audio.size).astype(np.float32)


__all__ = ["spectral_gate_denoise"]
