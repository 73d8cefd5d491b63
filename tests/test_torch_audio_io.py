"""WAV reading and resampling of the PyTorch port against the JAX package.

The same WAV files, written from a numpy seed in several encodings, go through
``ser_tpu._internal.utils.audio_io`` and the port's copy: the mono, peak-
normalized samples agree to 1e-6 (the JAX package may take its native decoder,
which matches the python path to that level), the sample rates are equal, and
polyphase resampling to 16 kHz is identical.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from ser_tpu._internal.utils import audio_io as jax_audio_io
from ser_tpu_torch._internal.utils import audio_io


def _wav_bytes(samples: np.ndarray, sample_rate: int, *, fmt: str) -> bytes:
    """RIFF/WAVE bytes for (frames, channels) samples in [-1, 1]."""
    channels = samples.shape[1]
    if fmt == "pcm16":
        tag, bits, payload = 1, 16, (samples * 32767).astype("<i2").tobytes()
    elif fmt == "pcm24":
        ints = np.round(samples * (2**23 - 1)).astype("<i4").reshape(-1)
        tag, bits = 1, 24
        payload = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in ints)
    elif fmt == "float32":
        tag, bits, payload = 3, 32, samples.astype("<f4").tobytes()
    else:
        raise ValueError(fmt)
    block = channels * bits // 8
    header = struct.pack("<HHIIHH", tag, channels, sample_rate, sample_rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + header + b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize(
    ("fmt", "channels", "sample_rate"),
    [("pcm16", 1, 22050), ("pcm24", 2, 48000), ("float32", 2, 16000), ("float32", 1, 44100)],
)
def test_read_and_resample_match_ser_tpu(tmp_path, fmt, channels, sample_rate) -> None:
    rng = np.random.default_rng(sample_rate + channels)
    samples = np.clip(0.3 * rng.standard_normal((sample_rate // 4, channels)), -1.0, 1.0)
    path = tmp_path / f"clip_{fmt}.wav"
    path.write_bytes(_wav_bytes(samples, sample_rate, fmt=fmt))

    ours, our_rate = audio_io.read_audio_file(str(path))
    reference, reference_rate = jax_audio_io.read_audio_file(str(path))
    assert our_rate == reference_rate == sample_rate
    assert ours.dtype == np.float32 and ours.shape == reference.shape == (sample_rate // 4,)
    np.testing.assert_allclose(ours, reference, atol=1e-6)

    np.testing.assert_array_equal(
        audio_io.resample_audio(ours, our_rate, 16000), jax_audio_io.resample_audio(ours, our_rate, 16000)
    )


def test_git_lfs_pointer_is_refused(tmp_path) -> None:
    path = tmp_path / "pointer.wav"
    path.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    with pytest.raises(audio_io.AudioIntegrityError, match="Git LFS"):
        audio_io.read_audio_file(str(path))
