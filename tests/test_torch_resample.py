"""Resampling to 16 kHz into the encoders' padded rows (``ops/resample.py``, ``csrc/resample.cu``).

On the CPU, the plain version against scipy's ``resample_poly`` (what
``audio_io.resample_audio`` runs, and what the encoder backends ran before):

- lengths: ``ceil(n · up / down)``, and every value of every clip of 1..4000
  samples (rows that point at prefixes of one buffer), at 48, 44.1, 32, 22.05
  and 8 kHz, and the formula at long lengths;
- values: clips of 4 s and 75 s within 1e-7 max-abs;
- the row layout: rows made from descriptors equal, padding included, the
  numpy layout the backends made from the resampled clip (Whisper's windows,
  ``chunked_encode_many``'s bucket batches with a row that starts inside its
  clip and padding rows, clips of three rates in one batch);
- the kernel's index arithmetic, emulated in numpy: tiles, items, the
  register ring, the 16-byte staging and the padding;
- the backends on a CPU device: the same frames and times as before, that
  is, as encoding the clip resampled by ``resample_audio`` at 16 kHz;
- the wrapper's refusals that need no card: a wrong dtype, mixed devices,
  a ratio not reduced, bad shapes.

The kernel itself runs only on a CUDA card; ``chip_smoke.py`` (phase
``resample``) holds it to the plain version there. This file imports no JAX.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from ser_tpu_torch._internal.repr import encoder_backend
from ser_tpu_torch._internal.utils.audio_io import resample_audio
from ser_tpu_torch.ops import resample

RATES = (48000, 44100, 32000, 22050, 8000)
KERNEL_THREADS, KERNEL_PER_THREAD = 128, 7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on a few cores: one intra-op thread each keeps the plain
    version's block-wide ops from contending for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(n: int, seed: int) -> np.ndarray:
    """Noise and a tone, peak 0.8: float32 rounding of the output stays under 1e-7."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    audio = 0.3 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return (0.8 * audio / max(1e-9, np.abs(audio).max())).astype(np.float32)


def _rows(placements, row_samples, up, down, n_rows=None) -> torch.Tensor:
    return torch.from_numpy(resample.row_descriptors(placements, row_samples, up, down, n_rows))


# --------------------------------------------------------------------------- #
# Lengths and values
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rate", RATES)
def test_every_length_up_to_4000_matches_resample_poly(rate):
    up, down = resample.ratio(rate, 16000)
    x = _clip(4000, seed=rate)
    source = torch.from_numpy(x)
    for lengths in np.array_split(np.arange(1, 4001), 16):
        expected = [resample_poly(x[:n].astype(np.float64), up, down) for n in lengths]
        outs = [resample.resampled_length(n, up, down) for n in lengths]
        assert outs == [e.size for e in expected]
        # Clip n is the buffer's first n samples (its length field cuts it), one row each.
        rows = _rows([(0, n, 0, m) for n, m in zip(lengths, outs)], max(outs), up, down)
        made = resample.resample_rows(source, rows, up, down, max(outs)).numpy()
        for n, m, row, reference in zip(lengths, outs, made, expected):
            assert np.abs(row[:m] - reference.astype(np.float32)).max() <= 1e-7, n
            assert not row[m:].any()


@pytest.mark.parametrize("rate", (*RATES, 16000, 11025, 96000))
@pytest.mark.parametrize("n", (4001, 65537, 10**6 + 7, 48000 * 600 + 1))
def test_long_lengths_match_resample_poly(rate, n):
    up, down = resample.ratio(rate, 16000)
    made = resample.resampled_length(n, up, down)
    assert made == -(-n * 16000 // rate) == encoder_backend.encoder_length(n, rate)
    if n <= 65537:
        assert made == (n if (up, down) == (1, 1) else resample_poly(np.zeros(n), up, down).size)


@pytest.mark.parametrize(("rate", "seconds"), [(rate, 4.0) for rate in RATES] + [(48000, 75.0), (44100, 75.0)])
def test_values_match_resample_audio(rate, seconds):
    audio = _clip(int(seconds * rate) + 13, seed=int(seconds))
    up, down = resample.ratio(rate, 16000)
    expected = resample_audio(audio, rate, 16000)
    rows = _rows([(0, audio.size, 0, expected.size)], expected.size, up, down)
    made = resample.resample_rows(torch.from_numpy(audio), rows, up, down, expected.size)[0].numpy()
    assert made.dtype == np.float32 and made.shape == expected.shape
    assert np.abs(made - expected).max() <= 1e-7


def test_at_16_khz_the_rows_are_the_samples():
    audio = _clip(40000, seed=3)
    assert resample.ratio(16000, 16000) == (1, 1)
    rows = _rows([(0, audio.size, 0, 30000), (0, audio.size, 30000, 10000)], 30000, 1, 1, n_rows=3)
    made = resample.resample_rows(torch.from_numpy(audio), rows, 1, 1, 30000).numpy()
    np.testing.assert_array_equal(made[0], audio[:30000])
    np.testing.assert_array_equal(made[1, :10000], audio[30000:])
    assert not made[1, 10000:].any() and not made[2].any()


def test_the_filter_is_resample_polys():
    """A unit impulse through ``resample_poly`` gives its filter, aligned; the table holds it."""
    for rate in RATES:
        up, down = resample.ratio(rate, 16000)
        taps = resample.filter_taps(up, down)
        half = resample.half_length(up, down)
        assert taps.size == 2 * half + 1 and np.allclose(taps, taps[::-1]) and taps.sum() == pytest.approx(up)
        table = resample.polyphase_table(up, down)
        for r in (0, up // 2, up - 1):
            k = np.arange(table.shape[1])
            inside = r + up * k <= 2 * half
            np.testing.assert_array_equal(table[r, inside], taps[r + up * k[inside]])
            assert not table[r, ~inside].any()


def test_descriptors_that_overrun_raise():
    up, down = resample.ratio(48000, 16000)
    with pytest.raises(ValueError, match="past its clip"):
        resample.row_descriptors([(0, 300, 0, 101)], 200, up, down)
    with pytest.raises(ValueError, match="valid <= row_samples"):
        resample.row_descriptors([(0, 3000, 0, 201)], 200, up, down)
    with pytest.raises(ValueError, match="reduced ratio"):
        resample.resample_rows(torch.zeros(9), torch.zeros((1, 4), dtype=torch.int64), 2, 6, 3)
    with pytest.raises(TypeError, match="float32"):
        resample.resample_rows(torch.zeros(9, dtype=torch.float64), torch.zeros((1, 4), dtype=torch.int64), 1, 3, 3)


# --------------------------------------------------------------------------- #
# The row layout against the backends' numpy layout
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rate", (48000, 44100))
def test_whisper_windows_match_the_numpy_layout(rate):
    """20 windows with a ragged tail (windows of 4800 samples, for the CPU's sake: the layout does not
    depend on the window's size), the way ``WhisperEncoderBackend.encode_sequence`` laid them out."""
    chunk = 4800
    audio = _clip(math.ceil((19 * chunk + 1234) * rate / 16000), seed=20)
    audio16k = resample_audio(audio, rate, 16000)
    n16 = encoder_backend.encoder_length(audio.size, rate)
    assert audio16k.size == n16
    n_chunks = math.ceil(n16 / chunk)
    batch = np.zeros((n_chunks, chunk), dtype=np.float32)
    for row in range(n_chunks):
        piece = audio16k[row * chunk : (row + 1) * chunk]
        batch[row, : piece.size] = piece
    windows = [(0, row * chunk, min(chunk, n16 - row * chunk)) for row in range(n_chunks)]
    made = encoder_backend.StagedClips([(audio, rate)], "cpu").rows(windows, chunk).numpy()
    assert made.shape == (20, chunk)
    assert np.abs(made - batch).max() <= 1e-7
    assert not made[-1, n16 - 19 * chunk :].any() and made[-1, n16 - 19 * chunk - 1] != 0.0


def _bucket_batches(n_samples, frames_for_length, max_batch_chunks=32, attention_score_budget=5e7):
    """``chunked_encode_many``'s plan: (bucket, batch cap, [(clip, start, length)]) per batch."""
    work = [(clip, start, length) for clip, n in enumerate(n_samples)
            for start, length in encoder_backend.plan_chunks(n) if frames_for_length(length) > 0]
    by_bucket: dict[int, list] = {}
    for item in work:
        by_bucket.setdefault(encoder_backend.bucket_samples(item[2]), []).append(item)
    for bucket in sorted(by_bucket):
        cap = max(1, min(max_batch_chunks, int(attention_score_budget // max(1, frames_for_length(bucket)) ** 2)))
        for first in range(0, len(by_bucket[bucket]), cap):
            yield bucket, cap, by_bucket[bucket][first : first + cap]


def test_bucket_batches_match_the_numpy_layout():
    """Clips at 48, 44.1 and 16 kHz: a 65 s clip's second and third chunks start inside it, and read
    the samples before them; every batch has padding rows; one batch holds all three rates."""
    clips = [(_clip(65 * 48000 + 5, seed=1), 48000), (_clip(int(0.8 * 44100), seed=2), 44100),
             (_clip(int(0.7 * 16000), seed=3), 16000), (_clip(int(0.9 * 48000), seed=4), 48000)]
    resampled = [resample_audio(audio, rate, 16000) for audio, rate in clips]
    assert [a.size for a in resampled] == [encoder_backend.encoder_length(a.size, r) for a, r in clips]

    def frames_for_length(n):
        return (n - 400) // 320 + 1

    staged = encoder_backend.StagedClips(clips, "cpu")
    batches = list(_bucket_batches([a.size for a in resampled], frames_for_length))
    assert any(start > 0 for _, _, items in batches for _, start, _ in items)
    assert any(len({clips[c][1] for c, _, _ in items}) == 3 for _, _, items in batches)
    for bucket, cap, items in batches:
        expected = np.zeros((cap, bucket), dtype=np.float32)
        for row, (clip, start, length) in enumerate(items):
            expected[row, :length] = resampled[clip][start : start + length]
        made = staged.rows(items, bucket, cap).numpy()
        assert made.shape == (cap, bucket) and len(items) < cap
        assert np.abs(made - expected).max() <= 1e-7
        assert not made[len(items):].any()


def _emulate_kernel(source, rows, up, down, row_samples):
    """``csrc/resample.cu``'s arithmetic in numpy (float32 sums, the staged form): its tiles and items,
    the span staged from a 16-byte boundary, the register ring per tap class, the shared output
    tile."""
    half, kt = resample.half_length(up, down), resample.polyphase_table(up, down).shape[1]
    table = resample.kernel_table(up, down)
    items = up * ((KERNEL_THREADS + up - 1) // up)
    tile, r_ = items * KERNEL_PER_THREAD, KERNEL_PER_THREAD
    capacity = ((((tile - 1) * down) // up + 1 + kt + 7) + 3) & ~3
    tiles_per_row = -(-row_samples // tile)
    out = np.full((rows.shape[0], row_samples), np.nan, dtype=np.float32)
    for block in range(rows.shape[0] * tiles_per_row):
        row, c0 = block // tiles_per_row, (block % tiles_per_row) * tile
        columns = min(tile, row_samples - c0)
        offset, length, start, valid = (int(v) for v in rows[row])
        if c0 >= valid:
            out[row, c0 : c0 + columns] = 0.0
            continue
        o0 = start + c0
        first = (o0 * down + half) // up - (kt - 1)
        last = ((o0 + tile - 1) * down + half) // up
        a0 = (offset + first) & ~3
        lead = offset + first - a0
        absolute = a0 + np.arange(4 * ((offset + last - a0) // 4 + 1))
        assert absolute.size <= capacity
        inside = (absolute >= offset) & (absolute < offset + length)
        xs = np.where(inside, source[np.where(inside, absolute, 0)], 0.0).astype(np.float32)
        ys = np.full(tile, np.nan, dtype=np.float32)
        for item in range(items):
            q = (item // up) * up * r_ + item % up
            base = (o0 + q) * down + half
            hi = base // up - first
            taps = table[(base % up) * kt : (base % up + 1) * kt]
            acc = np.zeros(r_, dtype=np.float32)
            tap = 0
            for rho in range(min(kt, down)):
                count, z0 = (kt - 1 - rho) // down + 1, hi - rho
                ring = [xs[lead + z0 + t * down] for t in range(r_)]
                for j in range(count):
                    if j > 0:
                        ring[(-j) % r_] = xs[lead + z0 - j * down]
                    for t in range(r_):
                        acc[t] = np.float32(acc[t] + np.float32(taps[tap + j] * ring[(t - j) % r_]))
                tap += count
            for t in range(r_):
                m = q + t * up
                ys[m] = acc[t] if c0 + m < valid else 0.0
        out[row, c0 : c0 + columns] = ys[:columns]
    return out


@pytest.mark.parametrize("rate", (48000, 44100, 8000, 32000, 16000))
def test_the_kernels_index_arithmetic_emulated(rate):
    """Two clips in one buffer (the second off 16-byte alignment), rows of 4000 that end inside a
    tile, a row that starts inside its clip, and a padding row: the emulation writes every
    position, and agrees with the plain version to float32 sums."""
    up, down = resample.ratio(rate, 16000)
    clips = [_clip(int(0.41 * rate), seed=5), _clip(int(0.13 * rate), seed=6)]
    offsets = [0, clips[0].size + 3]
    flat = np.zeros(offsets[1] + clips[1].size, dtype=np.float32)
    flat[: clips[0].size], flat[offsets[1] :] = clips
    n16 = [resample.resampled_length(c.size, up, down) for c in clips]
    width = 4000
    placements = [(offsets[0], clips[0].size, 0, min(width, n16[0])),
                  (offsets[0], clips[0].size, width, min(width, n16[0] - width)),
                  (offsets[1], clips[1].size, 0, n16[1])]
    rows = resample.row_descriptors(placements, width, up, down, n_rows=4)
    plain = resample.resample_rows(torch.from_numpy(flat), torch.from_numpy(rows), up, down, width).numpy()
    emulated = _emulate_kernel(flat, rows, up, down, width)
    assert not np.isnan(emulated).any() and not emulated[3].any()
    assert np.abs(emulated - plain).max() <= 1e-6


# --------------------------------------------------------------------------- #
# The backends on a CPU device
# --------------------------------------------------------------------------- #


def _same_sequence(ours, before) -> None:
    np.testing.assert_array_equal(ours.frame_start_seconds, before.frame_start_seconds)
    np.testing.assert_array_equal(ours.frame_end_seconds, before.frame_end_seconds)
    assert ours.embeddings.shape == before.embeddings.shape
    np.testing.assert_allclose(ours.embeddings, before.embeddings, rtol=0, atol=1e-6)


@pytest.mark.parametrize(("rate", "seconds"), [(48000, 31.5), (44100, 3.2)])
def test_whisper_backend_gives_the_frames_and_times_of_before(rate, seconds, monkeypatch, tmp_path):
    from ser_tpu_torch._internal.repr.whisper_backend import WhisperEncoderBackend

    monkeypatch.setenv("SER_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("SER_RANDOM_INIT_SIZE", "tiny")
    backend = WhisperEncoderBackend(model_id="openai/whisper-large-v3", cache_root=tmp_path, device="cpu")
    audio = _clip(int(seconds * rate), seed=7)
    ours = backend.encode_sequence(audio, rate)
    before = backend.encode_sequence(resample_audio(audio, rate, 16000), 16000)
    _same_sequence(ours, before)


def test_chunked_encode_many_gives_the_frames_and_times_of_before(tmp_path):
    from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend

    backend = XlsrBackend(model_id="facebook/wav2vec2-xls-r-300m", cache_root=tmp_path, device="cpu", init="random")
    clips = [(_clip(int(3.3 * 48000), seed=8), 48000), (_clip(int(1.2 * 22050), seed=9), 22050),
             (_clip(int(0.6 * 48000), seed=10), 48000)]
    ours = backend.encode_sequences(clips)
    before = backend.encode_sequences([(resample_audio(audio, rate, 16000), 16000) for audio, rate in clips])
    assert len(ours) == len(before) == 3
    for mine, theirs in zip(ours, before):
        _same_sequence(mine, theirs)
    single = backend.encode_sequence(*clips[0])
    _same_sequence(single, backend.encode_sequence(resample_audio(clips[0][0], 48000, 16000), 16000))


def test_a_call_over_the_byte_budget_is_staged_in_groups(tmp_path, monkeypatch):
    from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend

    backend = XlsrBackend(model_id="facebook/wav2vec2-xls-r-300m", cache_root=tmp_path, device="cpu", init="random")
    clips = [(_clip(int(s * 48000), seed=11 + i), 48000) for i, s in enumerate((1.1, 0.8, 2.5, 0.6))]
    whole = backend.encode_sequences(clips)
    staged = []
    original = encoder_backend.StagedClips.__init__

    def recording(self, group, device):
        staged.append(len(group))
        original(self, group, device)

    monkeypatch.setattr(encoder_backend.StagedClips, "__init__", recording)
    monkeypatch.setattr(encoder_backend, "STAGE_BYTES", 4 * int(2.0 * 48000))
    grouped = backend.encode_sequences(clips)
    assert staged == [2, 1, 1]
    for mine, theirs in zip(grouped, whole):
        _same_sequence(mine, theirs)


# --------------------------------------------------------------------------- #
# The wrapper's refusals
# --------------------------------------------------------------------------- #


def test_wrapper_refuses_other_dtypes():
    source = torch.zeros(4800)
    rows = torch.tensor([[0, 4800, 0, 1600]], dtype=torch.int64)
    with pytest.raises(TypeError, match="float32"):
        resample.resample_rows(source.double(), rows, 1, 3, 1600)
    with pytest.raises(TypeError, match="int64"):
        resample.resample_rows(source, rows.int(), 1, 3, 1600)


def test_wrapper_refuses_a_source_and_rows_on_two_devices():
    source = torch.zeros(4800)
    rows = torch.tensor([[0, 4800, 0, 1600]], dtype=torch.int64)
    with pytest.raises(ValueError, match="one CUDA device"):
        resample.resample_rows(source, rows.to("meta"), 1, 3, 1600)
    with pytest.raises(ValueError, match="one CUDA device"):
        resample.resample_rows(source.to("meta"), rows, 1, 3, 1600)


@pytest.mark.parametrize(
    ("source_shape", "rows_shape", "up", "down", "row_samples"),
    [((4800,), (1, 4), 2, 6, 1600), ((4800,), (1, 4), 0, 3, 1600), ((1, 4800), (1, 4), 1, 3, 1600),
     ((4800,), (1, 3), 1, 3, 1600), ((4800,), (0, 4), 1, 3, 1600), ((4800,), (1, 4), 1, 3, 0)],
)
def test_wrapper_refuses_bad_ratios_and_shapes(source_shape, rows_shape, up, down, row_samples):
    with pytest.raises(ValueError):
        resample.resample_rows(torch.zeros(source_shape), torch.zeros(rows_shape, dtype=torch.int64), up, down,
                               row_samples)
