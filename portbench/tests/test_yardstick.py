"""The yardstick's arithmetic against hand-worked values."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import spec
from portbench.harness import yardstick as ys


def _config(name: str) -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_whisper_window_flops():
    # 2·(3000·3·128·1280 + 1500·3·1280² + 32·(4·1500·1280² + 2·1500²·1280 + 2·1500·1280·5120)).
    assert ys.whisper_window_flops(_config("whisper-large-v3")) == pytest.approx(2.2738e12, rel=1e-4)
    assert ys.whisper_windows(1) == 1 and ys.whisper_windows(480000) == 1 and ys.whisper_windows(480001) == 2


def test_k2_work_and_bound():
    flops, moved = ys.attention_work(8, 20, 1500, 1500, 64)
    assert flops == pytest.approx(92.16e9)
    assert ys.bound_seconds(flops, moved, ys.PEAK_BF16_FLOPS) * 1e3 == pytest.approx(0.0932, abs=5e-5)


def test_k1_work_and_bound():
    flops, moved = ys.k1_work(8)
    assert flops == pytest.approx(23.2e9, rel=2e-3)
    assert moved == pytest.approx(29.2e6, rel=2e-3)
    assert ys.bound_seconds(flops, moved, ys.PEAK_TF32_FLOPS) * 1e3 == pytest.approx(0.0468, abs=5e-5)


def test_wav2vec2_counts():
    config = _config("xlsr-300m")
    assert ys.wav2vec2_frames(config, 480000) == 1499 and ys.wav2vec2_frames(config, 399) == 0
    assert ys.wav2vec2_frames(config, 400) == 1
    flops = ys.wav2vec2_chunk_flops(config, 480000)
    t, d = 1499, 1024
    layers = 24 * (2 * (4 * t * d * d + 2 * t * d * 4096) + 4 * t * t * d)
    assert layers < flops < layers * 1.3
    assert ys.wav2vec2_chunks(1_000_000, 30) == [480000, 480000, 40000]


@pytest.mark.parametrize("samples,rate", [(48000 * 7 + 13, 48000), (16000 * 3, 16000), (44100 * 2 + 1, 44100)])
def test_resampled_length_is_scipys(samples, rate):
    from scipy.signal import resample_poly

    g = np.gcd(rate, 16000)
    expected = resample_poly(np.zeros(samples), 16000 // g, rate // g).size if rate != 16000 else samples
    assert ys.resampled_length(samples, rate) == expected
