"""Audio loading built from first principles (no librosa/soundfile dependency).

Parity surface: reference ``ser/_internal/utils/audio_utils.py:28-162`` —
Git-LFS pointer detection, NaN scrubbing, mono mixdown, peak normalization to
[-1, 1] and the retry policy. The decoder is an in-house RIFF/WAVE
parser (PCM 8/16/24/32-bit, IEEE float 32/64, WAVE_FORMAT_EXTENSIBLE) because
neither librosa nor soundfile is a dependency; other containers raise
``AudioDecodeError``.

Copied from ``ser_tpu/_internal/utils/audio_io.py``: a whole-file read takes
the native C++ decoder (``native_audio.py``: decode, mixdown and
normalization in one pass, the JAX package's bits) when it builds, else this
Python decoder, which lands within 1 ulp of it.
"""

from __future__ import annotations

import struct
import time
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from ser_tpu_torch._internal.config.schema import AudioReadConfig
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

_GIT_LFS_POINTER_PREFIX = b"version https://git-lfs.github.com/spec/v1"
_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def is_git_lfs_pointer(path: Path) -> bool:
    """True when the file holds a Git-LFS pointer instead of audio bytes."""
    with Path(path).open("rb") as handle:
        return handle.read(len(_GIT_LFS_POINTER_PREFIX)) == _GIT_LFS_POINTER_PREFIX


class AudioIntegrityError(OSError):
    """Raised when a path contains metadata in place of audio bytes."""


class AudioDecodeError(OSError):
    """Raised when an otherwise regular media file cannot be decoded locally."""


def _decode_wav_bytes(data: bytes) -> tuple[NDArray[np.float32], int]:
    """Decodes a RIFF/WAVE byte buffer to float32 samples (frames, channels)."""
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("Not a RIFF/WAVE file.")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise AudioDecodeError("Malformed fmt chunk.")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 40:
                # SubFormat GUID: first two bytes carry the actual format tag.
                (sub_format,) = struct.unpack_from("<H", body, 24)
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            payload = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise AudioDecodeError("WAV file missing fmt or data chunk.")
    format_tag, channels, sample_rate, _, block_align, bits = fmt
    if channels <= 0 or sample_rate <= 0:
        raise AudioDecodeError("WAV file has invalid channel count or sample rate.")

    def _whole(width: int) -> bytes:
        # A truncated data chunk (interrupted copy) trims to whole samples —
        # the 24-bit path and the native C++ decoder already do; frombuffer
        # would raise on a ragged tail instead.
        usable_len = (len(payload) // width) * width
        return payload[:usable_len]

    if format_tag == _WAVE_FORMAT_PCM:
        if bits == 8:
            samples = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(_whole(2), dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8)
            usable = (raw.size // 3) * 3
            triplets = raw[:usable].reshape(-1, 3).astype(np.uint32)
            values = triplets[:, 0] | (triplets[:, 1] << 8) | (triplets[:, 2] << 16)
            signed = values.astype(np.int32)
            signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
            samples = signed.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            samples = np.frombuffer(_whole(4), dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise AudioDecodeError(f"Unsupported PCM bit depth: {bits}.")
    elif format_tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            samples = np.frombuffer(_whole(4), dtype="<f4").astype(np.float32)
        elif bits == 64:
            samples = np.frombuffer(_whole(8), dtype="<f8").astype(np.float32)
        else:
            raise AudioDecodeError(f"Unsupported float bit depth: {bits}.")
    else:
        raise AudioDecodeError(f"Unsupported WAV format tag: 0x{format_tag:04x}.")

    usable_frames = samples.size // channels
    return samples[: usable_frames * channels].reshape(-1, channels), int(sample_rate)


def _to_mono(audio: NDArray[np.float32]) -> NDArray[np.float32]:
    """Converts (frames, channels) to mono by channel mean."""
    if audio.ndim == 1:
        return audio
    if audio.ndim == 2:
        if audio.shape[1] == 0:
            return np.array([], dtype=np.float32)
        return np.mean(audio, axis=1, dtype=np.float32)
    raise OSError(f"Unsupported audio shape: {audio.shape}")


def _normalize_peak(audio: NDArray[np.float32]) -> NDArray[np.float32]:
    """Normalizes amplitude to [-1, 1]; all-zero audio stays zero."""
    if audio.size == 0:
        return audio
    max_abs = float(np.max(np.abs(audio)))
    if max_abs == 0.0:
        return np.zeros_like(audio)
    return audio / max_abs


def _prepare_audio_buffer(raw: NDArray[np.float32]) -> NDArray[np.float32]:
    """NaN-scrubs, mixes down, validates, and peak-normalizes decoded samples."""
    prepared = np.asarray(raw, dtype=np.float32)
    prepared = np.nan_to_num(prepared, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
    prepared = _to_mono(prepared)
    if prepared.size == 0:
        raise OSError("Audio file contains no samples.")
    return _normalize_peak(prepared)


def read_audio_file(
    file_path: str,
    *,
    audio_read_config: AudioReadConfig | None = None,
) -> tuple[NDArray[np.float32], int]:
    """Reads an audio file and normalizes amplitude to [-1, 1].

    Returns ``(audio_samples, sample_rate)`` with mono float32 samples.
    """
    config = audio_read_config if audio_read_config is not None else AudioReadConfig()
    path = Path(file_path)
    if not path.exists():
        # The three-arg form populates ``.filename`` — the failure taxonomy's
        # proven-missing-sample check keys on it (training_readiness.
        # classify_failure), so the message-only form would misclassify a
        # vanished sample as an aborting defect.
        import errno as _errno

        raise FileNotFoundError(_errno.ENOENT, "Audio file not found", str(file_path))
    if not path.is_file():
        raise OSError(f"Path is not a regular file: {file_path}")
    if is_git_lfs_pointer(path):
        raise AudioIntegrityError(
            f"Audio file is an unmaterialized Git LFS pointer: {file_path}. "
            "Install Git LFS, then run `git lfs pull` and `git lfs checkout` "
            "in the dataset checkout."
        )

    last_error: Exception | None = None
    for attempt in range(config.max_retries):
        try:
            raw_bytes = path.read_bytes()
            from ser_tpu_torch._internal.utils import native_audio

            if native_audio.native_decoder_available():
                try:
                    return native_audio.decode_wav_mono_native(raw_bytes)
                except native_audio.NativeDecodeError as err:
                    raise AudioDecodeError(str(err)) from err
            frames, sample_rate = _decode_wav_bytes(raw_bytes)
            return _prepare_audio_buffer(frames), sample_rate
        except (AudioDecodeError, OSError, ValueError) as err:
            last_error = err
            detail = str(err).strip() or type(err).__name__
            logger.warning("Failed to read audio file (attempt %d): %s", attempt + 1, detail)
            if attempt < config.max_retries - 1:
                time.sleep(config.retry_delay_seconds)

    error = AudioDecodeError(f"Error reading {file_path}")
    if last_error is None:
        raise error
    raise error from last_error


def resample_audio(
    audio: NDArray[np.float32], orig_sr: int, target_sr: int
) -> NDArray[np.float32]:
    """Polyphase resampling to the encoder sample rate (e.g. 16 kHz)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    resampled = resample_poly(audio.astype(np.float64), target_sr // g, orig_sr // g)
    return np.asarray(resampled, dtype=np.float32)


def write_wav(
    file_path: str | Path,
    audio: NDArray[np.float32],
    sample_rate: int,
) -> None:
    """Writes mono float32 samples as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim != 1:
        raise ValueError(
            f"write_wav takes mono (N,) samples, got shape {audio.shape}; "
            "mix down before writing (the header would claim mono over an "
            "interleaved payload)."
        )
    clipped = np.clip(audio, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype("<i2")
    payload = pcm.tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM, 1, sample_rate, sample_rate * 2, 2, 16)
    data = b"data" + struct.pack("<I", len(payload)) + payload
    Path(file_path).write_bytes(header + fmt + data)


__all__ = [
    "AudioDecodeError",
    "AudioIntegrityError",
    "read_audio_file",
    "resample_audio",
    "write_wav",
]
