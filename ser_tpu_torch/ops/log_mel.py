"""Whisper's log-mel frontend: kernel K1 in its fused form, and its parts.

Counterpart of ``ser_tpu/ops/pallas_kernels.py``. There the STFT is XLA work
(``conv_stft``) in front of the Pallas call that computes power → mel → log10
(``_power_mel_log_kernel_3d``). Kernel K1 (source ``csrc/log_mel.cu``)
replaces both, in two forms:

- ``stft_power_mel_log``, the fused form, on the main path (``log_mel_raw`` on
  the card): the waveform in, the raw log-mel out, with the reflect-centred
  framing and the DFT (three TF32 tensor-core products a product,
  float32-grade) inside the kernel, so that no spectrum reaches device memory.
  Whisper's framing only (n_fft 400, hop 160).
- ``power_mel_log``, the spectrum form: the TPU kernel's own boundary, the
  [re | im] spectrum in. It is held to the JAX package's Pallas call and
  checked on the card, and no path of the port launches it.

Each has a plain version that a CPU tensor takes: ``stft`` (reflect centering,
``1 + S // hop`` frames cut with ``unfold``, and one float32 matmul against the
Hann-windowed DFT basis) followed by ``power_mel_log_reference`` (power = re² +
im², the Slaney mel projection in float32, log10(max(mel, 1e-10))). The STFT
is not a ``conv1d``: cuDNN runs float32 convolutions in TF32 by default, which
would break the 5e-5 log-mel tolerance, and ``set_strict_float32`` turns TF32
off for matmuls and convolutions. The max-8 floor and the (x+4)/4 affine
reduce over a whole window and stay outside the kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ser_tpu_torch.ops import filters, kernel_build

#: Launches of kernel K1's spectrum form (its wrapper adds one per launch).
COUNTER = kernel_build.KernelCounter("power_mel_log")
#: Launches of kernel K1's fused form, the main path's (its wrapper adds one per launch).
FUSED_COUNTER = kernel_build.KernelCounter("stft_power_mel_log")

#: The framing the fused form takes (Whisper's).
FUSED_N_FFT, FUSED_HOP = 400, 160
#: The fused form's basis layout (``csrc/log_mel.cu``): N tiles of 64 interleaved
#: (re, im) columns, K chunks of 32 taps, both padded with zeros.
_N_TILE, _N_TILES, _K_CHUNK, _K_CHUNKS = 64, 7, 32, 13
#: The fused form's filterbank: at most one mel filter per consumer thread.
_MAX_MELS = 128


def set_strict_float32() -> None:
    """Float32 matmuls and convolutions in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@lru_cache(maxsize=8)
def _dft_basis64(n_fft: int) -> np.ndarray:
    """Hann-windowed DFT basis (n_fft, 2 * n_bins) in float64: [real_0..real_K | imag_0..imag_K]."""
    n_bins = n_fft // 2 + 1
    window = filters.hann_window(n_fft).astype(np.float64)
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    angle = -2.0 * np.pi * k * n / n_fft
    real = np.cos(angle) * window[:, None]
    imag = np.sin(angle) * window[:, None]
    return np.concatenate([real, imag], axis=1)


@lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> np.ndarray:
    """:func:`_dft_basis64` rounded to float32."""
    return _dft_basis64(n_fft).astype(np.float32)


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def fused_basis_columns() -> np.ndarray:
    """The fused form's basis as a (taps, columns) matrix, float32: column 2k is
    re_k, column 2k + 1 is im_k, zero-padded to 32·13 taps and 64·7 columns."""
    basis = _dft_basis(FUSED_N_FFT)
    n_bins = basis.shape[1] // 2
    columns = np.zeros((_K_CHUNK * _K_CHUNKS, _N_TILE * _N_TILES), dtype=np.float32)
    columns[:FUSED_N_FFT, 0 : 2 * n_bins : 2] = basis[:, :n_bins]
    columns[:FUSED_N_FFT, 1 : 2 * n_bins : 2] = basis[:, n_bins:]
    return columns


#: The fused form's tap order inside a K chunk: k-step kk's slot s (kernel row
#: position 8 kk + s) holds tap 8 (s % 4) + 2 kk + s // 4, so that a thread's
#: slots t and t + 4 over the chunk's 4 k-steps are its taps 8 t .. 8 t + 7.
CHUNK_TAP_ORDER = np.array([8 * (s % 4) + 2 * kk + s // 4 for kk in range(4) for s in range(8)])


@lru_cache(maxsize=1)
def packed_fused_basis() -> np.ndarray:
    """The fused form's basis as the kernel streams it, flat float32.

    :func:`fused_basis_columns` split into hi = TF32(x) and lo = TF32(x − hi),
    cut into (N tile, K chunk) stages in that order, each stage the hi tile and
    then the lo tile: 64 rows (columns of the basis) of 32 taps in
    :data:`CHUNK_TAP_ORDER`, 128 bytes a row, the 16-byte group q of row n
    stored at group q ^ (n % 8) (wgmma's 128-byte swizzle).
    """
    columns = fused_basis_columns()
    hi = round_tf32(columns)
    lo = round_tf32(columns - hi)
    rows = np.arange(_N_TILE)[:, None]
    groups = np.arange(8)[None, :]

    def tiles(matrix: np.ndarray) -> np.ndarray:
        # (taps, columns) -> [N tile][K chunk][row n][group q][4 taps], then swizzled.
        cut = matrix.T.reshape(_N_TILES, _N_TILE, _K_CHUNKS, _K_CHUNK)[..., CHUNK_TAP_ORDER]
        cut = cut.reshape(_N_TILES, _N_TILE, _K_CHUNKS, 8, 4).transpose(0, 2, 1, 3, 4)
        swizzled = np.empty_like(cut)
        swizzled[:, :, rows, groups ^ (rows % 8)] = cut[:, :, rows, groups]
        return swizzled

    return np.ascontiguousarray(np.stack([tiles(hi), tiles(lo)], axis=2)).reshape(-1)


_ON_DEVICE: dict[tuple, torch.Tensor] = {}


def _constant_on(device: torch.device, make, *args) -> torch.Tensor:
    """``make(*args)`` (a cached numpy constant) on ``device``, copied there once.

    A copy from pageable host memory waits for the card's stream, so a copy
    per call would hold the host at every front-end call.
    """
    key = (device, make.__name__, *args)
    tensor = _ON_DEVICE.get(key)
    if tensor is None:
        tensor = _ON_DEVICE[key] = torch.from_numpy(make(*args)).to(device)
    return tensor


@lru_cache(maxsize=8)
def _mel_fb_t(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney filterbank transposed to (n_bins, n_mels), float32."""
    return np.ascontiguousarray(filters.mel_filterbank(sr, n_fft, n_mels).T)


def stft(waveform: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, S) float32 → (B, 1 + S // hop, 2 * n_bins) [re | im], reflect-centered.

    A float64 waveform takes the basis in float64 (a reference for the
    float32 routes' own error).
    """
    pad = n_fft // 2
    padded = F.pad(waveform[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + waveform.shape[1] // hop_length
    frames = padded.unfold(-1, n_fft, hop_length)[:, :n_frames]
    basis = _constant_on(waveform.device, _dft_basis64 if waveform.dtype == torch.float64 else _dft_basis, n_fft)
    return torch.matmul(frames, basis)


def power_mel_log_reference(
    spec: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Plain version of K1's spectrum form: log10(max((re² + im²) @ fb, 1e-10)) in float32."""
    n_bins = fb.shape[0]
    if n_frames_out is not None:
        spec = spec[:, :n_frames_out]
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def power_mel_log(
    spec: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Kernel K1, spectrum form. (B, T, 2 * n_bins) spectrum + (n_bins, n_mels) → (B, T_out, n_mels).

    ``n_frames_out`` (default T) keeps the first frames only, written directly
    by the kernel. A CPU tensor takes :func:`power_mel_log_reference`.

    Replaces ``ser_tpu/ops/pallas_kernels.py::_power_mel_log_kernel_3d``. On the
    H100 it is bound by bytes: for 8 windows it moves about 51 MB (spectrum in,
    log-mel out) against 0.04 GFLOP over the filterbank's non-zero weights. The
    kernel reads the spectrum once and keeps the power in shared memory, never
    in device memory (``csrc/log_mel.cu``).
    """
    if spec.device.type == "cpu":
        return power_mel_log_reference(spec, fb, n_frames_out)
    batch, frames, two_bins = spec.shape
    n_bins, n_mels = fb.shape
    out_frames = frames if n_frames_out is None else n_frames_out
    if spec.device.type != "cuda" or fb.device != spec.device:
        raise ValueError("power_mel_log takes spec and fb on one CUDA device.")
    if spec.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("power_mel_log takes float32 spec and fb.")
    if two_bins != 2 * n_bins or not 0 < out_frames <= frames:
        raise ValueError(f"Bad shapes: spec {tuple(spec.shape)}, fb {tuple(fb.shape)}, out {out_frames}.")
    if not (spec.is_contiguous() and fb.is_contiguous()):
        raise ValueError("power_mel_log takes contiguous tensors.")
    kernel_build.refuse_grad("power_mel_log", spec, fb)
    entry = kernel_build.load("log_mel")
    out = torch.empty((batch, out_frames, n_mels), dtype=torch.float32, device=spec.device)
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    code = entry(spec.data_ptr(), fb.data_ptr(), out.data_ptr(), batch, frames, out_frames, n_bins, n_mels, stream)
    kernel_build.check(code, "power_mel_log")
    COUNTER.launches += 1
    return out


def stft_power_mel_log_reference(
    waveform: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Plain version of K1's fused form: :func:`stft` then :func:`power_mel_log_reference`."""
    return power_mel_log_reference(stft(waveform, FUSED_N_FFT, FUSED_HOP), fb, n_frames_out)


def stft_power_mel_log(
    waveform: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Kernel K1, fused form. (B, S) waveform + (201, n_mels) → (B, T_out, n_mels) raw log-mel.

    Whisper's framing (n_fft 400, hop 160, reflect-centred), T = 1 + S // 160
    frames, of which the first ``n_frames_out`` (default T) are written. A CPU
    tensor takes :func:`stft_power_mel_log_reference`.

    Replaces ``ser_tpu/ops/pallas_kernels.py::_power_mel_log_kernel_3d`` and the
    ``conv_stft`` in front of it. On the H100 it is bound by its products: for 8
    windows, 7.7 GFLOP formed as three TF32 products each (0.047 ms), against
    about 29 MB of waveform, basis and log-mel. The kernel reads each window's
    samples once and keeps the frames, the spectrum and the power out of device
    memory (``csrc/log_mel.cu``).
    """
    if waveform.device.type == "cpu":
        return stft_power_mel_log_reference(waveform, fb, n_frames_out)
    if waveform.device.type != "cuda" or fb.device != waveform.device:
        raise ValueError("stft_power_mel_log takes waveform and fb on one CUDA device.")
    if waveform.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("stft_power_mel_log takes a float32 waveform and fb.")
    if waveform.dim() != 2 or fb.dim() != 2:
        raise ValueError(f"Bad shapes: waveform {tuple(waveform.shape)}, fb {tuple(fb.shape)}.")
    batch, samples = waveform.shape
    n_bins, n_mels = fb.shape
    frames = 1 + samples // FUSED_HOP
    out_frames = frames if n_frames_out is None else n_frames_out
    if (
        batch < 1
        or samples <= FUSED_N_FFT // 2
        or n_bins != FUSED_N_FFT // 2 + 1
        or not 0 < n_mels <= _MAX_MELS
        or not 0 < out_frames <= frames
    ):
        raise ValueError(f"Bad shapes: waveform {tuple(waveform.shape)}, fb {tuple(fb.shape)}, out {out_frames}.")
    if not (waveform.is_contiguous() and fb.is_contiguous()):
        raise ValueError("stft_power_mel_log takes contiguous tensors.")
    kernel_build.refuse_grad("stft_power_mel_log", waveform, fb)
    entry = kernel_build.load("stft_power_mel_log")
    basis = _constant_on(waveform.device, packed_fused_basis)
    out = torch.empty((batch, out_frames, n_mels), dtype=torch.float32, device=waveform.device)
    stream = torch.cuda.current_stream(waveform.device).cuda_stream
    code = entry(
        waveform.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(), batch, samples, out_frames, n_mels,
        stream,
    )
    kernel_build.check(code, "stft_power_mel_log")
    FUSED_COUNTER.launches += 1
    return out


def log_mel_raw(
    waveform: torch.Tensor,
    *,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 128,
    n_frames_out: int | None = None,
) -> torch.Tensor:
    """log10-clamped mel power, (B, S) → (B, T_out, n_mels); counterpart of
    ``ser_tpu.ops.pallas_kernels.fused_log_mel_raw``.

    On the card, K1's fused form (Whisper's framing only: any other n_fft or
    hop raises); on the CPU, the matmul STFT and K1's plain version.
    """
    waveform = waveform.to(torch.float32)
    fb = _constant_on(waveform.device, _mel_fb_t, sr, n_fft, n_mels)
    if waveform.device.type == "cpu":
        return power_mel_log(stft(waveform, n_fft, hop_length).contiguous(), fb, n_frames_out)
    if (n_fft, hop_length) != (FUSED_N_FFT, FUSED_HOP):
        raise ValueError(
            f"K1's fused form takes n_fft {FUSED_N_FFT} and hop {FUSED_HOP}, not {n_fft} and {hop_length}."
        )
    if waveform.device.type == "cuda":
        set_strict_float32()  # the callers' float32 products stay full float32, as before
    return stft_power_mel_log(waveform.contiguous(), fb, n_frames_out)


def normalize_log_mel(log_mel: torch.Tensor) -> torch.Tensor:
    """Whisper's dynamic-range floor at max-8 per window, then (x+4)/4."""
    floor = torch.amax(log_mel, dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_mel, floor) + 4.0) / 4.0


def log_mel(
    waveform: torch.Tensor,
    *,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 128,
) -> torch.Tensor:
    """Whisper-normalized log-mel, (B, S) → (B, 1 + S // hop, n_mels); counterpart
    of ``ser_tpu.ops.pallas_kernels.fused_log_mel``."""
    raw = log_mel_raw(waveform, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    return normalize_log_mel(raw)


__all__ = [
    "CHUNK_TAP_ORDER",
    "COUNTER",
    "FUSED_COUNTER",
    "FUSED_HOP",
    "FUSED_N_FFT",
    "fused_basis_columns",
    "log_mel",
    "log_mel_raw",
    "normalize_log_mel",
    "packed_fused_basis",
    "power_mel_log",
    "power_mel_log_reference",
    "round_tf32",
    "set_strict_float32",
    "stft",
    "stft_power_mel_log",
    "stft_power_mel_log_reference",
]
