"""Kernel K1's fused form, its arithmetic and layouts emulated on the CPU.

K1's fused form (``log_mel.stft_power_mel_log``, ``csrc/log_mel.cu``) takes the
waveform: it copies each work item's samples into shared memory (reflected
at the window's ends, stored skewed), reads the frames' A fragments straight
from there, forms the DFT on the tensor cores as three TF32 products of split
operands (a = hi + lo, each rounded to TF32; lo_a·hi_b + hi_a·lo_b +
hi_a·hi_b) against a basis that the wrapper splits, interleaves as (re_k,
im_k) column pairs, pads and swizzles once, sums each 32-tap chunk in an
accumulator of its own, and keeps the power out of device memory. This file
repeats that arithmetic in numpy, with the span, the word map and the packed
basis exactly as the kernel addresses them, and holds it at the JAX
package's 5e-5 pin to ``ser_tpu``'s log-mel (Pallas interpret mode, and the
Whisper front end's CPU branch) on one 30 s window, while one TF32 pass stays
above that pin. It also checks the index maps (the skew is free of bank
conflicts for the A-fragment loads, the reflection matches ``F.pad``), the
packed basis, the tile constants, and that a CPU tensor takes the plain
version and launches nothing.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ser_tpu.models import whisper as jax_whisper
from ser_tpu.ops import pallas_kernels
from ser_tpu_torch.ops import kernel_build, log_mel

ATOL = 5e-5  # the JAX package's pin for its fused log-mel (tests/suites/unit/ops/test_pallas_and_native.py)
SOURCE = (kernel_build.CSRC_DIR / "log_mel.cu").read_text(encoding="utf-8")
WINDOW = jax_whisper.CHUNK_SAMPLES  # one 30 s window at 16 kHz


def _constant(name: str) -> int:
    match = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert match, f"{name} not found in log_mel.cu"
    expression = re.sub(r"//.*", "", match.group(1))
    names = {key: _constant(key) for key in re.findall(r"\bk[A-Z]\w*", expression)}
    return int(eval(expression.replace("/", "//"), {}, names))  # the source's integer arithmetic


FFT, HOP, PAD, SKEW = _constant("kFft"), _constant("kHop"), _constant("kPad"), _constant("kSkew")
ITEM_FRAMES, N_TILE, N_TILES = _constant("kItemFrames"), _constant("kNTile"), _constant("kNTiles")
K_CHUNK, K_CHUNKS = _constant("kKChunk"), _constant("kKChunks")
SPAN_SAMPLES, SPAN_WORDS = _constant("kSpanSamples"), _constant("kSpanWords")
POWER_STRIDE = _constant("kPowerStride")
TAPS, COLUMNS = K_CHUNK * K_CHUNKS, N_TILE * N_TILES


def _reflect(s: np.ndarray, n: int) -> np.ndarray:
    """The kernel's ``reflect``: F.pad(mode="reflect") for |s| < n, clamped beyond."""
    s = np.where(s < 0, -s, s)
    s = np.where(s >= n, 2 * (n - 1) - s, s)
    return np.clip(s, 0, n - 1)


def _word(i: np.ndarray) -> np.ndarray:
    """Shared-memory word of span sample i."""
    return i + SKEW * (i // HOP)


def _item_frames(wave: np.ndarray, item: int) -> np.ndarray:
    """(ITEM_FRAMES, TAPS) A operand of one work item of one window, read as the consumers read it."""
    first = item * ITEM_FRAMES * HOP - PAD
    words = np.full(SPAN_WORDS, np.nan, dtype=np.float32)
    i = np.arange(SPAN_SAMPLES)
    words[_word(i)] = wave[_reflect(first + i, wave.shape[0])]
    rows = np.arange(ITEM_FRAMES)[:, None]
    taps = np.arange(TAPS)[None, :]
    return words[rows * (HOP + SKEW) + taps + SKEW * (taps // HOP)]


def _unpack_basis() -> tuple[np.ndarray, np.ndarray]:
    """The packed basis back to (TAPS, COLUMNS) hi and lo matrices."""
    packed = log_mel.packed_fused_basis().reshape(N_TILES, K_CHUNKS, 2, N_TILE, 8, 4)
    rows = np.arange(N_TILE)[:, None]
    groups = np.arange(8)[None, :]
    unswizzled = np.empty_like(packed)
    unswizzled[..., rows, groups, :] = packed[..., rows, groups ^ (rows % 8), :]
    unswizzled = unswizzled.reshape(N_TILES, K_CHUNKS, 2, N_TILE, K_CHUNK)
    plain = np.empty_like(unswizzled)
    plain[..., log_mel.CHUNK_TAP_ORDER] = unswizzled  # row position p holds tap CHUNK_TAP_ORDER[p]
    # [N tile][K chunk][part][column][taps] -> [part][taps][columns]
    matrices = plain.transpose(2, 1, 4, 0, 3)
    matrices = matrices.reshape(2, TAPS, COLUMNS)
    return matrices[0], matrices[1]


def _emulate(wave: np.ndarray, fb: np.ndarray, out_frames: int, mode: str = "split") -> np.ndarray:
    """K1's fused form on (B, S) float32: raw log-mel (B, out_frames, n_mels).

    ``mode`` "split" is the kernel's arithmetic; "tf32" one TF32 product per
    product (a planted fault).
    """
    b_hi, b_lo = _unpack_basis()
    n_bins = fb.shape[0]
    items = -(-out_frames // ITEM_FRAMES)
    result = []
    for window in wave:
        a = np.concatenate([_item_frames(window, item) for item in range(items)])[:out_frames]
        a_hi = log_mel.round_tf32(a)
        a_lo = log_mel.round_tf32(a - a_hi)
        if mode == "tf32":
            spec = (a_hi.astype(np.float64) @ b_hi).astype(np.float32)
        else:
            spec = np.zeros((out_frames, COLUMNS), dtype=np.float32)
            for chunk in range(K_CHUNKS):
                cut = slice(chunk * K_CHUNK, (chunk + 1) * K_CHUNK)
                part = (
                    a_lo[:, cut].astype(np.float64) @ b_hi[cut]
                    + a_hi[:, cut].astype(np.float64) @ b_lo[cut]
                    + a_hi[:, cut].astype(np.float64) @ b_hi[cut]
                )
                spec = spec + part.astype(np.float32)
        re_, im_ = spec[:, 0 : 2 * n_bins : 2], spec[:, 1 : 2 * n_bins : 2]
        power = re_ * re_ + im_ * im_
        result.append(np.log10(np.maximum(power @ fb, np.float32(1e-10))))
    return np.stack(result).astype(np.float32)


def _normalize(raw: np.ndarray) -> np.ndarray:
    return log_mel.normalize_log_mel(torch.from_numpy(raw)).numpy()


def _noise(seed: int, batch: int = 1, samples: int = WINDOW) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, samples))).astype(np.float32)


def _tone(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(WINDOW) / 16000.0
    return (np.sin(2 * np.pi * 440.0 * t) + 1e-4 * rng.standard_normal(WINDOW))[None, :].astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulated_kernel_matches_pallas_kernel_in_interpret_mode(n_mels: int) -> None:
    wave = _noise(n_mels)
    frames = 1 + WINDOW // HOP
    ours = _normalize(_emulate(wave, log_mel._mel_fb_t(16000, FFT, n_mels), frames))
    ref = np.asarray(pallas_kernels.fused_log_mel(jnp.asarray(wave), n_mels=n_mels, interpret=True))
    assert ours.shape == ref.shape == (1, frames, n_mels)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulated_kernel_matches_whisper_log_mel_spectrogram(n_mels: int) -> None:
    wave = np.concatenate([_noise(n_mels + 1), _tone(n_mels + 2)])
    ours = _normalize(_emulate(wave, log_mel._mel_fb_t(16000, FFT, n_mels), jax_whisper.CHUNK_FRAMES))
    ref = np.asarray(jax_whisper.log_mel_spectrogram(jnp.asarray(wave), n_mels))
    assert ours.shape == ref.shape == (2, jax_whisper.CHUNK_FRAMES, n_mels)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_one_tf32_pass_exceeds_the_limit(n_mels: int) -> None:
    """The planted fault that chip_smoke.py's K1 phase must catch: one TF32 product a product."""
    wave = np.concatenate([_noise(n_mels + 3), _tone(n_mels + 4)])
    fb = log_mel._mel_fb_t(16000, FFT, n_mels)
    ref = np.asarray(jax_whisper.log_mel_spectrogram(jnp.asarray(wave), n_mels))
    faulty = _normalize(_emulate(wave, fb, jax_whisper.CHUNK_FRAMES, mode="tf32"))
    for window in range(2):  # on noise and on the tone alike
        assert np.abs(faulty[window] - ref[window]).max() > 10 * ATOL


@pytest.mark.parametrize("signal", ["noise", "tone"])
def test_emulated_raw_error_is_within_twice_the_float32_route(signal: str) -> None:
    """chip_smoke.py's second check, on the CPU: the raw log-mel against float64."""
    wave = _noise(7) if signal == "noise" else _tone(8)
    fb = log_mel._mel_fb_t(16000, FFT, 128)
    frames = jax_whisper.CHUNK_FRAMES
    spec64 = log_mel.stft(torch.from_numpy(wave).double(), FFT, HOP)
    exact = log_mel.power_mel_log_reference(spec64, torch.from_numpy(fb).double(), frames).numpy()
    plain = log_mel.stft_power_mel_log_reference(torch.from_numpy(wave), torch.from_numpy(fb), frames).numpy()
    ours = _emulate(wave, fb, frames)
    assert np.abs(ours - exact).max() <= 2 * np.abs(plain - exact).max()


def test_skewed_span_has_no_bank_conflicts_in_a_fragment_loads() -> None:
    """Each 16-byte load of a row's 8 taps: the 8 lanes of a quarter-warp hit 8 different
    16-byte bank groups (with the skew; without it they would collide)."""
    lanes = np.arange(32)
    g, t4 = lanes >> 2, lanes & 3
    for warp in range(4):
        row0 = 16 * warp + g
        for chunk in range(K_CHUNKS):
            for row in (row0, row0 + 8):
                for half in (0, 4):
                    i = row * HOP + chunk * K_CHUNK + 8 * t4 + half  # span sample of the load's first tap
                    word = _word(i)
                    assert (word % 4 == 0).all()  # 16-byte aligned
                    for quarter in range(4):
                        assert len(set((word[8 * quarter : 8 * quarter + 8] // 4) % 8)) == 8
    unskewed = (16 * 0 + g) * HOP + 8 * t4
    assert len(set((unskewed[:8] // 4) % 8)) < 8


def test_chunk_tap_order_matches_the_fragment_loads() -> None:
    """Slot t4 of k-step kk is tap 8 t4 + 2 kk and slot t4 + 4 tap 8 t4 + 2 kk + 1, in the
    packed basis (CHUNK_TAP_ORDER) and in the kernel's loads alike."""
    order = log_mel.CHUNK_TAP_ORDER
    assert sorted(order.tolist()) == list(range(K_CHUNK))
    for kk in range(4):
        for t4 in range(4):
            assert order[8 * kk + t4] == 8 * t4 + 2 * kk
            assert order[8 * kk + t4 + 4] == 8 * t4 + 2 * kk + 1
    assert "const int offset = k0 + kSkew * (k0 / kHop) + 8 * t4;" in SOURCE
    assert "split_tf32_int(v[2 * kk], a_hi[kk][r], a_lo[kk][r]);" in SOURCE
    assert "split_tf32_int(v[2 * kk + 1], a_hi[kk][2 + r], a_lo[kk][2 + r]);" in SOURCE


def test_power_tile_stores_have_no_bank_conflicts() -> None:
    """A warp's stores of bin 4 j + t4 of rows g (and g + 8) fall on 32 banks."""
    lanes = np.arange(32)
    g, t4 = lanes >> 2, lanes & 3
    for j in range(8):
        for row in (g, g + 8):
            assert len(set((row * POWER_STRIDE + 4 * j + t4) % 32)) == 32


@pytest.mark.parametrize("samples", [WINDOW, 16000 + 77, 201])
def test_span_reads_the_frames_of_unfold(samples: int) -> None:
    wave = _noise(samples, samples=samples)[0]
    frames = 1 + samples // HOP
    padded = F.pad(torch.from_numpy(wave)[None, None], (PAD, PAD), mode="reflect")[0, 0]
    expected = padded.unfold(-1, FFT, HOP)[:frames].numpy()
    items = -(-frames // ITEM_FRAMES)
    ours = np.concatenate([_item_frames(wave, item) for item in range(items)])
    np.testing.assert_array_equal(ours[:frames, :FFT], expected)
    assert np.isfinite(ours).all()  # rows past T and taps past 400 read finite samples


@pytest.mark.parametrize("samples", [WINDOW, 16000 + 77, 201])
def test_reflection_matches_f_pad_at_both_window_ends(samples: int) -> None:
    index = torch.arange(samples, dtype=torch.float64)
    padded = F.pad(index[None, None], (PAD, PAD), mode="reflect")[0, 0].numpy().astype(np.int64)
    s = np.arange(-PAD, samples + PAD)
    np.testing.assert_array_equal(_reflect(s, samples), padded)
    # The kernel's function is the one emulated here.
    assert "if (s < 0) s = -s;" in SOURCE
    assert "if (s >= n) s = 2 * (n - 1) - s;" in SOURCE
    assert "return min(max(s, 0), n - 1);" in SOURCE


def test_packed_basis_is_the_interleaved_split_dft_basis() -> None:
    hi, lo = _unpack_basis()
    basis = log_mel._dft_basis(FFT)
    n_bins = basis.shape[1] // 2
    # hi and lo are TF32 values: their low 13 mantissa bits are zero.
    for part in (hi, lo):
        assert not (part.view(np.int32) & 0x1FFF).any()
    columns = log_mel.fused_basis_columns()
    np.testing.assert_array_equal(hi, log_mel.round_tf32(columns))
    np.testing.assert_array_equal(lo, log_mel.round_tf32(columns - hi))
    total = hi.astype(np.float64) + lo
    assert np.abs(total - columns).max() <= 2.0**-21 * np.abs(columns).max()
    # The columns are _dft_basis's, interleaved (re_k, im_k), and zero elsewhere.
    order = np.stack([np.arange(n_bins), n_bins + np.arange(n_bins)], axis=1).reshape(-1)
    np.testing.assert_array_equal(columns[:FFT, : 2 * n_bins], basis[:, order])
    assert not columns[FFT:].any() and not columns[:, 2 * n_bins :].any()
    assert sorted(order.tolist()) == list(range(2 * n_bins))


def test_tile_constants_agree_with_the_wrapper() -> None:
    layout = (log_mel._N_TILE, log_mel._N_TILES, log_mel._K_CHUNK, log_mel._K_CHUNKS)
    assert (N_TILE, N_TILES, K_CHUNK, K_CHUNKS) == layout
    assert (FFT, HOP) == (log_mel.FUSED_N_FFT, log_mel.FUSED_HOP)
    assert _constant("kMaxMels") == log_mel._MAX_MELS == 128
    assert COLUMNS >= 2 * (FFT // 2 + 1) and TAPS >= FFT
    assert HOP % K_CHUNK == 0  # a K chunk's taps share one skew
    assert ITEM_FRAMES == 64  # one wgmma row tile per work item
    assert SPAN_SAMPLES == (ITEM_FRAMES - 1) * HOP + TAPS
    assert _word(np.arange(SPAN_SAMPLES)).max() < SPAN_WORDS
    assert log_mel.packed_fused_basis().nbytes == N_TILES * K_CHUNKS * _constant("kStageBytes")
    assert _constant("kStageBytes") == 2 * N_TILE * K_CHUNK * 4
    assert _constant("kFusedSmem") <= 232_448  # what a block may have on Hopper


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing() -> None:
    wave = torch.from_numpy(_noise(5, batch=2, samples=16000 + 33))
    fb = torch.from_numpy(log_mel._mel_fb_t(16000, FFT, 128))
    frames = 1 + wave.shape[1] // HOP
    before = (log_mel.COUNTER.launches, log_mel.FUSED_COUNTER.launches)
    fused = log_mel.stft_power_mel_log(wave, fb, frames - 1)
    raw = log_mel.log_mel_raw(wave, n_frames_out=frames - 1)
    assert (log_mel.COUNTER.launches, log_mel.FUSED_COUNTER.launches) == before
    old_route = log_mel.power_mel_log_reference(log_mel.stft(wave, FFT, HOP).contiguous(), fb, frames - 1)
    assert fused.shape == (2, frames - 1, 128)
    assert torch.equal(fused, old_route)
    assert torch.equal(raw, old_route)


def test_other_devices_raise() -> None:
    wave = torch.zeros(1, WINDOW, device="meta")
    fb = torch.zeros(FFT // 2 + 1, 128, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        log_mel.stft_power_mel_log(wave, fb)
    with pytest.raises(ValueError, match="one CUDA device"):
        log_mel.log_mel_raw(wave)
    with pytest.raises(ValueError, match="n_fft 400 and hop 160"):
        log_mel.log_mel_raw(wave, n_fft=512)


def test_counters_tell_the_two_forms_apart() -> None:
    assert log_mel.COUNTER is not log_mel.FUSED_COUNTER
    assert (log_mel.COUNTER.name, log_mel.FUSED_COUNTER.name) == ("power_mel_log", "stft_power_mel_log")


def test_ablation_copies_find_their_anchors() -> None:
    """Each part that ``scripts/log_mel_ablation.py`` takes out is in the source once."""
    from ser_tpu_torch.scripts import log_mel_ablation

    for _name, edits in log_mel_ablation.COPIES:
        for anchor, _replacement in edits:
            assert SOURCE.count(anchor) == 1, anchor
