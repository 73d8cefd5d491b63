"""Log-mel frontend of the PyTorch port against the JAX package, on the CPU.

The port's CPU path is kernel K1's plain version (``power_mel_log_reference``)
after the matmul STFT. It is held at atol 5e-5 (the JAX package's own pin for
its fused kernel, ``tests/suites/unit/ops/test_pallas_and_native.py``) against
the TPU kernel run in Pallas interpret mode and against
``ser_tpu.models.whisper.log_mel_spectrogram``'s CPU branch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import whisper as jax_whisper
from ser_tpu.ops import pallas_kernels
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.ops import log_mel

ATOL = 5e-5


def _wave(samples: int, *, seed: int, batch: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, samples))).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("samples", [16000, 2 * 16000 + 77])
def test_log_mel_matches_pallas_kernel_in_interpret_mode(n_mels: int, samples: int) -> None:
    wave = _wave(samples, seed=n_mels + samples)
    ref = np.asarray(pallas_kernels.fused_log_mel(jnp.asarray(wave), n_mels=n_mels, interpret=True))
    ours = log_mel.log_mel(torch.from_numpy(wave), n_mels=n_mels).numpy()
    assert ours.shape == ref.shape == (2, 1 + samples // 160, n_mels)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_raw_log_mel_matches_pallas_raw(n_mels: int) -> None:
    wave = _wave(16000 + 33, seed=3, batch=1)
    ref = np.asarray(pallas_kernels.fused_log_mel_raw(jnp.asarray(wave), n_mels=n_mels, interpret=True))
    ours = log_mel.log_mel_raw(torch.from_numpy(wave), n_mels=n_mels).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_stft_matches_conv_stft() -> None:
    wave = _wave(8000 + 11, seed=5)
    ref = np.asarray(pallas_kernels.conv_stft(jnp.asarray(wave), 400, 160))
    ours = log_mel.stft(torch.from_numpy(wave), 400, 160).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_spectrogram_matches_jax_cpu_branch(n_mels: int) -> None:
    wave = _wave(jax_whisper.CHUNK_SAMPLES, seed=11)
    wave[1, 7 * 16000 :] = 0.0  # a partial window, zero-padded as the backend pads it
    ref = np.asarray(jax_whisper.log_mel_spectrogram(jnp.asarray(wave), n_mels))
    ours = torch_whisper.log_mel_spectrogram(torch.from_numpy(wave), n_mels).numpy()
    assert ours.shape == ref.shape == (2, jax_whisper.CHUNK_FRAMES, n_mels)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_power_mel_log_on_cpu_takes_the_plain_version() -> None:
    rng = np.random.default_rng(2)
    spec = torch.from_numpy(rng.standard_normal((2, 37, 402)).astype(np.float32))
    fb = torch.from_numpy(log_mel._mel_fb_t(16000, 400, 128))
    before = log_mel.COUNTER.launches
    out = log_mel.power_mel_log(spec, fb, n_frames_out=30)
    assert log_mel.COUNTER.launches == before
    power = spec[..., :201] ** 2 + spec[..., 201:] ** 2
    expected = np.log10(np.maximum(power.numpy()[:, :30] @ fb.numpy(), 1e-10))
    assert out.shape == (2, 30, 128)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-5)
