"""Host orchestration of the handcrafted feature extraction.

Counterpart of ``ser_tpu/ops/features.py``: variable-length audio onto the
batched program of ``ops/dsp.py``, on the device the caller names.

- A clip is cut into 3 s frames at a 1 s stride (truncated tails, empty
  frames skipped); the frames of at least 2048 samples go through the
  batched program in chunks of at most ``_MAX_DEVICE_ROWS`` rows, framed on
  the device from the chunk's own slice of the clip (rebased to its first
  frame), or framed on the host with ``SER_FAST_DEVICE_FRAMING=0``; both give
  the same rows.
- Frames shorter than 2048 samples take librosa's small-signal path (pad to
  at least 512, ``n_fft = min(size, 2048)`` and its mixed hop lengths).
- ``extract_feature_vectors_batch`` (the training loader's) takes one
  whole-clip vector per clip: the clips of one sample rate go through the
  batched program together, each row zero-padded to the chunk's longest
  clip and masked to its own length.

Differences from the JAX package: no batch sharding (one process drives
one card, and a request's rows stay on it, as ``shard_chunk_batch`` keeps a
request's chunks; see ``_internal/repr/encoder_backend.py``); and no
power-of-two buckets of rows, clip slices or whole-clip lengths. They bound
the number of programs XLA compiles, and eager PyTorch compiles none; every
row is computed alone and masked to its true length, so the results are the
same without them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ser_tpu_torch._internal.config.schema import FeatureFlags
from ser_tpu_torch.ops import dsp

_FFT_MIN_WINDOW = 512
_FULL_NFFT = 2048
_HOP = 512
#: Rows per device batch: bounds the transient memory of the STFT windows and
#: the 31-wide HPSS median windows, which scale with rows × frame length.
_MAX_DEVICE_ROWS = 128


def feature_dim(flags: FeatureFlags) -> int:
    """Feature dimensionality of one flag set (193 with every flag on)."""
    return 40 * flags.mfcc + 12 * flags.chroma + 128 * flags.mel + 7 * flags.contrast + 6 * flags.tonnetz


def pad_audio_for_fft(audio: np.ndarray, minimum_window: int = _FFT_MIN_WINDOW) -> np.ndarray:
    """Zero-pads short clips so spectral features can be computed safely."""
    if audio.size >= minimum_window:
        return audio
    return np.pad(audio, (0, minimum_window - audio.size))


def _validate(audio: np.ndarray, sample_rate: int) -> None:
    if sample_rate <= 0:
        raise ValueError("Sample rate must be a positive integer.")
    if audio.ndim != 1:
        raise ValueError("Audio must be mono (1D array).")
    if audio.size == 0:
        raise ValueError("Audio contains no samples.")
    if not np.all(np.isfinite(audio)):
        raise ValueError("Audio buffer is not finite everywhere.")


def _flag_kwargs(flags: FeatureFlags) -> dict[str, bool]:
    return {"mfcc": flags.mfcc, "chroma": flags.chroma, "mel": flags.mel, "contrast": flags.contrast,
            "tonnetz": flags.tonnetz}


def _batched_features(
    frames: np.ndarray, lengths: np.ndarray, sample_rate: int, flags: FeatureFlags, device: torch.device
) -> np.ndarray:
    """Host-framed rows through the batched program: (B, L) → (B, D) float32."""
    out = dsp.handcrafted_features_batch(
        torch.as_tensor(frames, dtype=torch.float32, device=device),
        torch.as_tensor(lengths, dtype=torch.int64, device=device),
        sr=sample_rate,
        **_flag_kwargs(flags),
    )
    return out.cpu().numpy()


def _clip_framed_features(
    audio: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    frame_length: int,
    sample_rate: int,
    flags: FeatureFlags,
    device: torch.device,
) -> np.ndarray:
    """Frames gathered on the device from the chunk's slice of the clip: (B, D) float32.

    The slice is rebased to the chunk's first frame, so each chunk copies
    only the audio its frames span, not the clip's whole prefix.
    """
    offset = int(starts.min())
    span = int(starts.max()) - offset + frame_length
    clip = np.zeros(span, dtype=np.float32)
    window = audio[offset : offset + span]
    clip[: window.size] = window
    out = dsp.handcrafted_features_clip(
        torch.as_tensor(clip, device=device),
        torch.as_tensor(starts - offset, dtype=torch.int64, device=device),
        torch.as_tensor(lengths, dtype=torch.int64, device=device),
        frame_length=frame_length,
        sr=sample_rate,
        **_flag_kwargs(flags),
    )
    return out.cpu().numpy()


def _features_small(audio: np.ndarray, sample_rate: int, flags: FeatureFlags, device: torch.device) -> np.ndarray:
    """Exact small-signal path for frames shorter than 2048 samples, float64.

    librosa's conventions for short inputs: the stft-magnitude features
    (chroma, contrast) use ``n_fft = len`` and ``hop = n_fft // 4``; mel and
    MFCC keep hop 512; tonnetz keeps n_fft 2048.
    """
    prepared = pad_audio_for_fft(np.asarray(audio, dtype=np.float32))
    n_fft = min(prepared.size, _FULL_NFFT)
    signal = torch.as_tensor(prepared[None, :], device=device)
    lengths = torch.tensor([prepared.size], device=device)

    def mask_for(mag: torch.Tensor, hop: int) -> torch.Tensor:
        return torch.arange(mag.shape[-1], device=device)[None, :] < (1 + lengths // hop)[:, None]

    def mean(values: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
        return dsp.masked_mean_cols(values, mask)[0].cpu().numpy()

    parts: list[np.ndarray] = []
    if flags.mfcc or flags.mel:
        mag_mel = dsp.stft_magnitude(signal, n_fft, _HOP)
        mel_mask = mask_for(mag_mel, _HOP)
        mel_pow = dsp.mel_power(mag_mel, sample_rate, n_fft)
    if flags.chroma or flags.contrast:
        hop = max(1, n_fft // 4)
        mag = dsp.stft_magnitude(signal, n_fft, hop)
        mask = mask_for(mag, hop)
    if flags.mfcc:
        parts.append(mean(dsp.mfcc_per_column(mel_pow, mel_mask), mel_mask))
    if flags.chroma:
        parts.append(mean(dsp.chroma_per_column(mag, mask, sample_rate, n_fft), mask))
    if flags.mel:
        parts.append(mean(mel_pow, mel_mask))
    if flags.contrast:
        s_db = dsp.power_to_db_ref_max(mag * mag, mask)
        parts.append(mean(dsp.spectral_contrast_per_column(s_db, mask, sample_rate, n_fft), mask))
    if flags.tonnetz:
        mag_t = dsp.stft_magnitude(signal, _FULL_NFFT, _HOP)
        mask_t = mask_for(mag_t, _HOP)
        # The column mask keeps the HPSS time median's edges those of the batched path.
        parts.append(mean(dsp.tonnetz_per_column(mag_t, sample_rate, _FULL_NFFT, col_mask=mask_t), mask_t))
    if not parts:
        return np.empty(0, dtype=np.float64)
    return np.concatenate(parts).astype(np.float64)


def extract_feature_from_signal(
    audio: np.ndarray,
    sample_rate: int,
    *,
    device: torch.device | str,
    feature_flags: FeatureFlags | None = None,
) -> np.ndarray:
    """Whole-signal feature vector, float64, in [mfcc, chroma, mel, contrast, tonnetz] order."""
    flags = feature_flags if feature_flags is not None else FeatureFlags()
    device = torch.device(device)
    _validate(np.asarray(audio), sample_rate)
    prepared = pad_audio_for_fft(np.asarray(audio, dtype=np.float32))
    if feature_dim(flags) == 0:
        return np.empty(0, dtype=np.float64)
    if prepared.size < _FULL_NFFT:
        return _features_small(prepared, sample_rate, flags, device)
    features = _batched_features(prepared[None, :], np.asarray([prepared.size]), sample_rate, flags, device)
    return features[0].astype(np.float64)


def extract_frame_features(
    audio: np.ndarray,
    sample_rate: int,
    *,
    device: torch.device | str,
    frame_size_seconds: float = 3.0,
    frame_stride_seconds: float = 1.0,
    feature_flags: FeatureFlags | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame-level features of one clip: ``(features (n, D) float32, start_seconds, end_seconds)``.

    Frames start every stride, are truncated at the clip's end, and empty
    frames are skipped.
    """
    flags = feature_flags if feature_flags is not None else FeatureFlags()
    device = torch.device(device)
    audio = np.asarray(audio, dtype=np.float32)
    _validate(audio, sample_rate)

    frame_length = max(1, int(round(frame_size_seconds * sample_rate)))
    frame_step = max(1, int(round(frame_stride_seconds * sample_rate)))
    starts = np.arange(0, audio.size, frame_step, dtype=np.int64)
    ends = np.minimum(starts + frame_length, audio.size)
    lengths = ends - starts
    keep = lengths > 0
    starts, ends, lengths = starts[keep], ends[keep], lengths[keep]
    if starts.size == 0:
        raise ValueError("Could not extract handcrafted features from provided audio.")

    features = np.zeros((starts.size, feature_dim(flags)), dtype=np.float32)
    bulk_idx = np.flatnonzero(lengths >= _FULL_NFFT)
    device_framing = os.environ.get("SER_FAST_DEVICE_FRAMING", "1").strip() != "0"
    for chunk_start in range(0, bulk_idx.size, _MAX_DEVICE_ROWS):
        chunk = bulk_idx[chunk_start : chunk_start + _MAX_DEVICE_ROWS]
        if device_framing:
            features[chunk] = _clip_framed_features(
                audio, starts[chunk], lengths[chunk], frame_length, sample_rate, flags, device
            )
            continue
        frames = np.zeros((chunk.size, frame_length), dtype=np.float32)
        for row, i in enumerate(chunk):
            frames[row, : lengths[i]] = audio[starts[i] : ends[i]]
        features[chunk] = _batched_features(frames, lengths[chunk], sample_rate, flags, device)
    for i in np.flatnonzero(lengths < _FULL_NFFT):
        features[i] = _features_small(audio[starts[i] : ends[i]], sample_rate, flags, device)
    return features, starts / float(sample_rate), ends / float(sample_rate)


def extract_feature_vectors_batch(
    clips: list[tuple[np.ndarray, int]],
    *,
    device: torch.device | str,
    feature_flags: FeatureFlags | None = None,
) -> np.ndarray:
    """Whole-clip feature vectors of many clips in few device calls: (n_clips, D) float64, in input order."""
    flags = feature_flags if feature_flags is not None else FeatureFlags()
    device = torch.device(device)
    out = np.zeros((len(clips), feature_dim(flags)), dtype=np.float64)
    by_rate: dict[int, list[tuple[int, np.ndarray]]] = {}
    for index, (audio, sample_rate) in enumerate(clips):
        audio = np.asarray(audio, dtype=np.float32)
        _validate(audio, sample_rate)
        prepared = pad_audio_for_fft(audio)
        if prepared.size < _FULL_NFFT:
            out[index] = _features_small(prepared, sample_rate, flags, device)
        else:
            by_rate.setdefault(sample_rate, []).append((index, prepared))
    for sample_rate, members in by_rate.items():
        for chunk_start in range(0, len(members), _MAX_DEVICE_ROWS):
            chunk = members[chunk_start : chunk_start + _MAX_DEVICE_ROWS]
            lengths = np.asarray([prepared.size for _, prepared in chunk])
            frames = np.zeros((len(chunk), int(lengths.max())), dtype=np.float32)
            for row, (_, prepared) in enumerate(chunk):
                frames[row, : prepared.size] = prepared
            rows = _batched_features(frames, lengths, sample_rate, flags, device)
            out[[index for index, _ in chunk]] = rows.astype(np.float64)
    return out


__all__ = [
    "extract_feature_from_signal",
    "extract_feature_vectors_batch",
    "extract_frame_features",
    "feature_dim",
    "pad_audio_for_fft",
]
