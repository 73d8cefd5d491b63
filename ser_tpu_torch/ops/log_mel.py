"""Whisper's log-mel frontend: the STFT as one matmul, then kernel K1.

Counterpart of ``ser_tpu/ops/pallas_kernels.py``. The STFT (``stft``) stays
plain PyTorch, as it was XLA work outside the Pallas call there: reflect
centering, ``1 + S // hop`` frames cut with ``unfold``, and one float32
matmul against the Hann-windowed DFT basis (``[re | im]`` columns). It is not
a ``conv1d``: cuDNN runs float32 convolutions in TF32 by default, which would
break the 5e-5 log-mel tolerance, and ``set_strict_float32`` turns TF32 off
for matmuls and convolutions on the path.

Kernel K1 (``power_mel_log``, source ``csrc/log_mel.cu``) replaces the TPU
kernel ``ser_tpu/ops/pallas_kernels.py::_power_mel_log_kernel_3d``: power =
re² + im², the Slaney mel projection in float32, and log10(max(mel, 1e-10)).
A CUDA tensor launches the kernel; a CPU tensor takes the plain version,
``power_mel_log_reference``, which does the same arithmetic. The max-8 floor
and the (x+4)/4 affine reduce over a whole window and stay outside the kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ser_tpu_torch.ops import filters, kernel_build

#: Launches of kernel K1 (its wrapper adds one per launch).
COUNTER = kernel_build.KernelCounter("power_mel_log")


def set_strict_float32() -> None:
    """Float32 matmuls and convolutions in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> np.ndarray:
    """Hann-windowed DFT basis (n_fft, 2 * n_bins): [real_0..real_K | imag_0..imag_K]."""
    n_bins = n_fft // 2 + 1
    window = filters.hann_window(n_fft).astype(np.float64)
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    angle = -2.0 * np.pi * k * n / n_fft
    real = np.cos(angle) * window[:, None]
    imag = np.sin(angle) * window[:, None]
    return np.concatenate([real, imag], axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def _mel_fb_t(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney filterbank transposed to (n_bins, n_mels), float32."""
    return np.ascontiguousarray(filters.mel_filterbank(sr, n_fft, n_mels).T)


def stft(waveform: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, S) float32 → (B, 1 + S // hop, 2 * n_bins) [re | im], reflect-centered."""
    pad = n_fft // 2
    padded = F.pad(waveform[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + waveform.shape[1] // hop_length
    frames = padded.unfold(-1, n_fft, hop_length)[:, :n_frames]
    basis = torch.from_numpy(_dft_basis(n_fft)).to(waveform.device)
    return torch.matmul(frames, basis)


def power_mel_log_reference(
    spec: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Plain version of K1: log10(max((re² + im²) @ fb, 1e-10)) in float32."""
    n_bins = fb.shape[0]
    if n_frames_out is not None:
        spec = spec[:, :n_frames_out]
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def power_mel_log(
    spec: torch.Tensor, fb: torch.Tensor, n_frames_out: int | None = None
) -> torch.Tensor:
    """Kernel K1. (B, T, 2 * n_bins) spectrum + (n_bins, n_mels) → (B, T_out, n_mels).

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
    ``ser_tpu.ops.pallas_kernels.fused_log_mel_raw``."""
    if waveform.device.type == "cuda":
        set_strict_float32()
    spec = stft(waveform.to(torch.float32), n_fft, hop_length).contiguous()
    fb = torch.from_numpy(_mel_fb_t(sr, n_fft, n_mels)).to(waveform.device)
    return power_mel_log(spec, fb, n_frames_out)


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
    "COUNTER",
    "log_mel",
    "log_mel_raw",
    "normalize_log_mel",
    "power_mel_log",
    "power_mel_log_reference",
    "set_strict_float32",
    "stft",
]
