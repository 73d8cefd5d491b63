"""The port's native C++ audio library against ``ser_tpu``'s, on the CPU.

Both packages build their own copy of ``seraudio.cpp`` with g++ at first use
(the port into ``build/native_audio/``). Held bit for bit: the decoded mono,
peak-normalized float32 samples and the rate of 16-bit, 24-bit, 32-bit float
and extensible WAVs, mono and stereo, through the decoders and through each
package's whole-file ``read_audio_file``; the refusals of malformed bytes
(same error codes and messages); the DTW path of the word timing, native in
both, and the port's native path equal to its numpy fallback. The Python
decoder stays within 1 ulp-level of the native one (1e-6).
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from ser_tpu._internal.utils import audio_io as jax_audio_io
from ser_tpu._internal.utils import native_audio as jax_native_audio
from ser_tpu.models import word_timing as jax_word_timing
from ser_tpu_torch._internal.utils import audio_io, native_audio
from ser_tpu_torch.models import word_timing


@pytest.fixture(autouse=True)
def _native_libraries():
    """Both libraries built (at first use, not at collection)."""
    if not (native_audio.native_decoder_available() and jax_native_audio.native_decoder_available()):
        pytest.skip("g++ cannot build the native audio library on this host")


def _wav_bytes(samples: np.ndarray, sample_rate: int, *, fmt: str) -> bytes:
    """RIFF/WAVE bytes for (frames, channels) samples in [-1, 1]."""
    channels = samples.shape[1]
    tag = 1
    if fmt == "pcm16":
        bits, payload = 16, (samples * 32767).astype("<i2").tobytes()
    elif fmt == "pcm24":
        ints = np.round(samples * (2**23 - 1)).astype("<i4").reshape(-1)
        bits = 24
        payload = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in ints)
    elif fmt in ("float32", "extensible-float32"):
        tag, bits, payload = 3, 32, samples.astype("<f4").tobytes()
    else:
        raise ValueError(fmt)
    block = channels * bits // 8
    if fmt.startswith("extensible"):
        # WAVE_FORMAT_EXTENSIBLE with the IEEE-float sub-format GUID.
        guid = struct.pack("<I", tag) + b"\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_chunk = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sample_rate, sample_rate * block, block, bits,
                                22, bits, 0) + guid
    else:
        fmt_chunk = struct.pack("<HHIIHH", tag, channels, sample_rate, sample_rate * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


CASES = [("pcm16", 1, 16000), ("pcm16", 2, 22050), ("pcm24", 1, 48000), ("pcm24", 2, 44100),
         ("float32", 1, 16000), ("float32", 2, 48000), ("extensible-float32", 2, 16000)]


@pytest.mark.parametrize(("fmt", "channels", "sample_rate"), CASES, ids=[f"{f}-{c}ch" for f, c, _ in CASES])
def test_native_decode_is_bit_equal(tmp_path, fmt: str, channels: int, sample_rate: int) -> None:
    rng = np.random.default_rng(sample_rate + channels)
    samples = np.clip(0.4 * rng.standard_normal((sample_rate // 5, channels)), -1.0, 1.0)
    samples[7] = np.nan if fmt.endswith("float32") else samples[7]  # the NaN scrub
    data = _wav_bytes(samples, sample_rate, fmt=fmt)
    ours, our_rate = native_audio.decode_wav_mono_native(data)
    theirs, their_rate = jax_native_audio.decode_wav_mono_native(data)
    assert our_rate == their_rate == sample_rate
    assert ours.dtype == np.float32 and ours.tobytes() == theirs.tobytes()

    path = tmp_path / f"{fmt}.wav"
    path.write_bytes(data)
    read, _ = audio_io.read_audio_file(str(path))
    jax_read, _ = jax_audio_io.read_audio_file(str(path))
    assert read.tobytes() == jax_read.tobytes() == ours.tobytes()
    python_path = audio_io._prepare_audio_buffer(audio_io._decode_wav_bytes(data)[0])
    np.testing.assert_allclose(ours, python_path, rtol=0, atol=1e-6)


@pytest.mark.parametrize("data", [b"", b"RIFF\x10\x00\x00\x00WAVEjunk", b"RIFF\x04\x00\x00\x00AVI ",
                                  _wav_bytes(np.zeros((0, 1)), 16000, fmt="pcm16")],
                         ids=["empty", "no-chunks", "not-wave", "no-samples"])
def test_malformed_bytes_refused_alike(data: bytes) -> None:
    with pytest.raises(native_audio.NativeDecodeError) as ours:
        native_audio.decode_wav_mono_native(data)
    with pytest.raises(jax_native_audio.NativeDecodeError) as theirs:
        jax_native_audio.decode_wav_mono_native(data)
    assert str(ours.value) == str(theirs.value)


def test_corrupt_file_read_refused_alike(tmp_path) -> None:
    path = tmp_path / "corrupt.wav"
    path.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunk")
    fast_retry = audio_io.AudioReadConfig(max_retries=1, retry_delay_seconds=0.0)
    with pytest.raises(audio_io.AudioDecodeError) as ours:
        audio_io.read_audio_file(str(path), audio_read_config=fast_retry)
    with pytest.raises(jax_audio_io.AudioDecodeError) as theirs:
        jax_audio_io.read_audio_file(str(path), audio_read_config=jax_audio_io.AudioReadConfig(
            max_retries=1, retry_delay_seconds=0.0))
    assert str(ours.value) == str(theirs.value) and str(ours.value.__cause__) == str(theirs.value.__cause__)


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (40, 1), (12, 90), (57, 300), (200, 140)])
def test_dtw_path_matches(shape: tuple[int, int]) -> None:
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    cost = rng.random(shape)
    cost[:, : shape[1] // 3] += np.linspace(0, 1, shape[0])[:, None]  # a monotone drift, not only noise
    ours = word_timing.dtw_path(cost)
    theirs = jax_word_timing.dtw_path(cost)
    for mine, reference in zip(ours, theirs):
        assert mine.dtype == reference.dtype and np.array_equal(mine, reference)
    native = word_timing._native_dtw_path(cost)
    assert native is not None and all(np.array_equal(a, b) for a, b in zip(native, ours))


def test_dtw_native_equals_numpy_fallback(monkeypatch: pytest.MonkeyPatch) -> None:
    cost = np.random.default_rng(7).random((33, 120))
    native = word_timing.dtw_path(cost)
    monkeypatch.setattr(word_timing, "_native_dtw_path", lambda cost: None)
    fallback = word_timing.dtw_path(cost)
    assert all(np.array_equal(a, b) for a, b in zip(native, fallback))


def test_library_is_built_under_the_checkout() -> None:
    path = native_audio.library_path()
    assert path.is_file() and path.parent == native_audio.BUILD_DIR
    assert path.parent.parent.name == "build" and (path.parents[2] / "ser_tpu_torch").is_dir()
