"""Vocal separation for the transcript's ``use_demucs`` lane: neural when staged, REPET-SIM else.

Counterpart of ``ser_tpu/_internal/utils/source_separation.py``. A staged
separator checkpoint (``model_path``, then
``settings.transcription.separation_model_path``, then
``SER_SEPARATION_MODEL_PATH``) takes the lane: a converted htdemucs ``.npz``
runs ``models/demucs_v4.py``, any other ``.npz`` the spectrogram U-Net of
``models/separation.py``, each on the device the caller gives (else the one
the settings resolve: the card, unless ``SER_TORCH_DEVICE=cpu``; with no card
a configured checkpoint raises). The weights load once per process and
device, and stay there.

With no checkpoint the lane is REPET-SIM (Rafii & Pardo, "Music/Voice
Separation Using the Similarity Matrix", ISMIR 2012), which needs no weights:
musical accompaniment repeats and voice does not, so each frame's repeating
background is the per-frequency median over its most similar frames, removed
with a soft time-frequency mask. Host numpy, once per file before chunking,
as in the JAX package; the similarity matmul runs through BLAS, segment by
segment. It is the lane without a checkpoint, not a fallback from the card.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

_EPS = 1e-10


def _stft(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    pad = n_fft // 2
    padded = np.pad(audio.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (padded.size - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(padded[idx] * window[None, :], axis=1)  # (T, F)


def _istft(spectrum: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    frames = np.fft.irfft(spectrum, n=n_fft, axis=1) * window[None, :]
    total = (spectrum.shape[0] - 1) * hop + n_fft
    signal = np.zeros(total)
    weight = np.zeros(total)
    window_sq = window * window
    for i in range(spectrum.shape[0]):
        start = i * hop
        signal[start : start + n_fft] += frames[i]
        weight[start : start + n_fft] += window_sq
    signal = signal / np.maximum(weight, _EPS)
    pad = n_fft // 2
    return signal[pad : pad + length]


def _repeating_mask(
    magnitude: np.ndarray,
    *,
    k_neighbors: int,
    min_frame_gap: int,
    similarity_floor: float,
) -> np.ndarray:
    """Soft background mask from the similarity-median repeating model.

    For each frame: rank all other frames by cosine similarity of magnitude
    spectra, keep the top-k outside ``min_frame_gap`` (adjacent frames are
    trivially similar and would model the VOICE as repeating), zero out
    neighbors below the similarity floor (a frame with no genuine repeats —
    plain speech — must keep NO background model; the zeroed entries drag the
    median to zero when fewer than half the neighbors qualify), and take the
    per-frequency median as the repeating background estimate. The mask is
    ``min(model, magnitude) / magnitude`` — the background can never exceed
    the mixture (Wiener-style clipping from the paper).
    """
    frames, _ = magnitude.shape
    norms = np.linalg.norm(magnitude, axis=1, keepdims=True)
    normalized = (magnitude / np.maximum(norms, _EPS)).astype(np.float32)
    similarity = normalized @ normalized.T  # (T, T) through BLAS

    offsets = np.abs(np.arange(frames)[:, None] - np.arange(frames)[None, :])
    similarity[offsets < min_frame_gap] = -np.inf

    k = min(k_neighbors, max(1, frames - min_frame_gap))
    neighbor_idx = np.argpartition(-similarity, kth=k - 1, axis=1)[:, :k]  # (T, k)
    qualifies = np.take_along_axis(similarity, neighbor_idx, axis=1) >= similarity_floor
    neighbor_mags = magnitude[neighbor_idx] * qualifies[:, :, None]  # (T, k, F)
    model = np.median(neighbor_mags, axis=1)  # (T, F)
    return np.minimum(model, magnitude) / np.maximum(magnitude, _EPS)


def separate_vocals(
    audio: np.ndarray,
    sample_rate: int,
    *,
    n_fft: int = 1024,
    hop: int = 256,
    k_neighbors: int = 12,
    min_gap_seconds: float = 0.3,
    segment_seconds: float = 30.0,
    high_pass_hz: float = 80.0,
    similarity_floor: float = 0.6,
) -> np.ndarray:
    """Removes the repeating musical background; returns the vocal estimate.

    Audio is processed in ``segment_seconds`` windows (the similarity matrix
    is O(T²)); a final high-pass keeps rumble the mask cannot attribute out
    of the vocal stem. Short or silent inputs pass through unchanged.
    """
    audio = np.asarray(audio, dtype=np.float64)
    length = audio.size
    min_gap = max(1, int(round(min_gap_seconds * sample_rate / hop)))
    segment = max(int(segment_seconds * sample_rate), n_fft * 4)
    if length < n_fft * 4 or float(np.max(np.abs(audio))) < _EPS:
        return audio.astype(np.float32)

    output = np.zeros(length)
    for start in range(0, length, segment):
        chunk = audio[start : start + segment]
        if chunk.size < n_fft * 4:
            output[start : start + chunk.size] = chunk
            continue
        spectrum = _stft(chunk, n_fft, hop)
        magnitude = np.abs(spectrum)
        background_mask = _repeating_mask(
            magnitude,
            k_neighbors=k_neighbors,
            min_frame_gap=min_gap,
            similarity_floor=similarity_floor,
        )
        vocal_spectrum = spectrum * (1.0 - background_mask)
        output[start : start + chunk.size] = _istft(vocal_spectrum, n_fft, hop, chunk.size)

    if high_pass_hz > 0:
        spectrum = np.fft.rfft(output)
        freqs = np.fft.rfftfreq(length, d=1.0 / sample_rate)
        rolloff = np.clip(freqs / max(high_pass_hz, 1.0), 0.0, 1.0)
        output = np.fft.irfft(spectrum * rolloff, n=length)
    return output.astype(np.float32)


#: (resolved path, device) → ("demucs_v4", (tree, config)) or ("spec_unet", module), on that device:
#: a checkpoint loads once per process and device.
_NEURAL_PARAM_CACHE: dict[tuple[str, str], tuple[str, object]] = {}

#: Missing-checkpoint paths already warned about (once per process per path).
_MISSING_WARNED: set[str] = set()


def _separation_device(settings) -> torch.device:
    """The device the settings resolve (``SER_TORCH_DEVICE`` when there are none)."""
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device

    request = settings.torch_runtime.device if settings is not None else os.environ.get("SER_TORCH_DEVICE", "auto")
    return resolve_device(request)


def _load_neural(path: str, device: torch.device, sample_rate: int) -> tuple[str, object]:
    """Sniffs the checkpoint's format once and places its weights on ``device``."""
    from ser_tpu_torch.models.demucs_v4 import is_demucs_npz, load_demucs_npz

    if is_demucs_npz(path):
        from ser_tpu_torch.models.convert import demucs_params

        params, config = load_demucs_npz(path)
        return "demucs_v4", (demucs_params(params, device=device), config)
    from ser_tpu_torch.models.separation import SeparatorConfig, build_separator, load_separator_params

    params, config = load_separator_params(path)
    return "spec_unet", build_separator(params, config or SeparatorConfig(sample_rate=sample_rate), device=device)


def separate_vocals_auto(
    audio: np.ndarray,
    sample_rate: int,
    *,
    settings=None,
    model_path=None,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Routes the ``use_demucs`` lane: the staged neural separator, else REPET-SIM.

    The checkpoint comes from ``model_path``, then
    ``settings.transcription.separation_model_path``, then
    ``SER_SEPARATION_MODEL_PATH``, as in the JAX package. A configured path
    that does not exist falls back to REPET-SIM with one warning. A U-Net
    checkpoint whose bundled sample rate is not the lane's raises.
    """
    path = Path(model_path) if model_path is not None else None
    if path is None and settings is not None:
        path = settings.transcription.separation_model_path
    if path is None:
        env_path = os.environ.get("SER_SEPARATION_MODEL_PATH")
        path = Path(env_path) if env_path else None
    if path is not None and not Path(path).exists():
        missing_key = str(path)
        if missing_key not in _MISSING_WARNED:
            _MISSING_WARNED.add(missing_key)
            logger.warning(
                "Configured separation checkpoint %s does not exist; the use_demucs lane falls back to the "
                "weight-free REPET-SIM separator.",
                path,
            )
        path = None
    if path is None:
        return separate_vocals(audio, sample_rate)

    device = torch.device(device) if device is not None else _separation_device(settings)
    key = (str(Path(path).resolve()), str(device))
    cached = _NEURAL_PARAM_CACHE.get(key)
    if cached is None:
        cached = _NEURAL_PARAM_CACHE[key] = _load_neural(key[0], device, sample_rate)
    kind, payload = cached
    if kind == "demucs_v4":
        from ser_tpu_torch.models.demucs_v4 import separate_vocals_demucs

        params, config = payload
        return separate_vocals_demucs(audio, sample_rate, params=params, config=config)

    from ser_tpu_torch.models.separation import separate_vocals_neural

    if payload.config.sample_rate != sample_rate:
        raise ValueError(
            f"Staged separator checkpoint expects {payload.config.sample_rate} Hz audio; the transcription "
            f"lane provides {sample_rate} Hz."
        )
    return separate_vocals_neural(audio, sample_rate, model=payload)


__all__ = ["separate_vocals", "separate_vocals_auto"]
