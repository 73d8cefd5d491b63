"""The port's fast-profile DSP against ``ser_tpu.ops.dsp``, the goldens and the analytic oracles.

On the CPU, float32, numpy-seeded inputs:

- each function of ``ser_tpu_torch.ops.dsp`` against its ``ser_tpu``
  counterpart on the same inputs (the STFT is pocketfft here and XLA's FFT
  there: float32 sums in another order, so 1e-5 relative to each output's
  scale, except where a function is exact in both);
- ``extract_frame_features`` on the golden fixtures
  (``tests/fixtures/dsp/golden_features_v2.npz``) at the tolerances that
  ``tests/suites/unit/ops/test_dsp_golden_fixtures.py`` pins for ``ser_tpu``;
- the closed-form oracles of ``tests/suites/unit/ops/test_dsp_analytic.py``
  (tuning of detuned tones, chroma class, HPSS mask, spectral contrast);
- the masked median of an even count (the mean of the two middle values,
  which ``torch.median`` would not give) and a tone near a histogram edge.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import dsp as jax_dsp
from ser_tpu_torch._internal.config.schema import FeatureFlags
from ser_tpu_torch.ops import dsp, filters
from ser_tpu_torch.ops.features import extract_frame_features

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests/fixtures/dsp/golden_features_v2.npz"
SR = 22050
N_FFT = 2048
#: Feature layout (the reference's concatenation order) and the golden tolerances,
#: atol per family times max(1, |golden|), rtol 2e-3 (``test_dsp_golden_fixtures.py``).
FAMILIES = {
    "mfcc": (slice(0, 40), 2e-3),
    "chroma": (slice(40, 52), 5e-3),
    "mel": (slice(52, 180), 2e-4),
    "contrast": (slice(180, 187), 2e-3),
    "tonnetz": (slice(187, 193), 5e-3),
}
GOLDEN_RTOL = 2e-3
SIGNALS = ("sine440", "chirp", "noise", "am_tone")
RATES = (16000, 22050)
#: Port against ``ser_tpu`` on the same float32 inputs, relative to the output's largest magnitude.
REL = 1e-5


def _close(ours: torch.Tensor, reference, rel: float = REL) -> None:
    reference = np.asarray(reference)
    scale = max(1.0, float(np.abs(reference).max()))
    np.testing.assert_allclose(ours.numpy(), reference, rtol=0, atol=rel * scale)


def _signals(seed: int = 0, batch: int = 3, seconds: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tones = [0.5 * np.sin(2 * np.pi * f * t) for f in (261.6, 440.0, 1234.5)][:batch]
    return np.stack([tone + 0.05 * rng.standard_normal(t.size) for tone in tones]).astype(np.float32)


@pytest.fixture(scope="module")
def spectra() -> dict:
    frames = _signals()
    lengths = np.array([frames.shape[1], frames.shape[1] - 5000, 7000])
    frames = frames * (np.arange(frames.shape[1])[None, :] < lengths[:, None])
    mag = dsp.stft_magnitude(torch.from_numpy(frames), N_FFT, 512)
    valid = 1 + lengths // 512
    col_mask = np.arange(mag.shape[-1])[None, :] < valid[:, None]
    return {"frames": frames, "lengths": lengths, "mag": mag, "col_mask": col_mask}


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.asarray(array))


@pytest.mark.parametrize("n_fft, hop", [(2048, 512), (1024, 256), (600, 150)])
def test_stft_magnitude(n_fft, hop) -> None:
    frames = _signals(seed=1)
    ours = dsp.stft_magnitude(torch.from_numpy(frames), n_fft, hop)
    reference = jax_dsp.stft_magnitude(jnp.asarray(frames), n_fft, hop)
    assert tuple(ours.shape) == reference.shape == (3, 1 + n_fft // 2, 1 + frames.shape[1] // hop)
    _close(ours, reference)


def test_power_to_db_scalar_and_per_frame_ref(spectra) -> None:
    power = spectra["mag"] ** 2
    mask = spectra["col_mask"]
    _close(dsp.power_to_db(power, _t(mask)), jax_dsp.power_to_db(jnp.asarray(power.numpy()), jnp.asarray(mask)))
    ref = np.array([1.0, 3.5, 1e-12], dtype=np.float32)
    _close(
        dsp.power_to_db(power, _t(mask), ref=_t(ref)),
        jax_dsp.power_to_db(jnp.asarray(power.numpy()), jnp.asarray(mask), ref=jnp.asarray(ref)),
    )


def test_power_to_db_ref_max_peaks_at_exactly_zero(spectra) -> None:
    power = spectra["mag"] ** 2
    mask = spectra["col_mask"]
    ours = dsp.power_to_db_ref_max(power, _t(mask))
    _close(ours, jax_dsp.power_to_db_ref_max(jnp.asarray(power.numpy()), jnp.asarray(mask)))
    peaks = torch.where(_t(mask)[:, None, :], ours, -1e9).amax(dim=(1, 2))
    assert torch.equal(peaks, torch.zeros(3))


def test_mel_power_and_mfcc(spectra) -> None:
    mask = spectra["col_mask"]
    mel = dsp.mel_power(spectra["mag"], SR, N_FFT)
    jax_mel = jax_dsp.mel_power(jnp.asarray(spectra["mag"].numpy()), SR, N_FFT)
    _close(mel, jax_mel)
    _close(dsp.mfcc_per_column(mel, _t(mask)), jax_dsp.mfcc_per_column(jax_mel, jnp.asarray(mask)))


def test_estimate_tuning_and_chroma(spectra) -> None:
    mag, mask = spectra["mag"], spectra["col_mask"]
    jax_mag = jnp.asarray(mag.numpy())
    tuning = dsp.estimate_tuning(mag, _t(mask), SR, N_FFT)
    np.testing.assert_allclose(tuning.numpy(), np.asarray(jax_dsp.estimate_tuning(jax_mag, jnp.asarray(mask), SR, N_FFT)),
                               atol=1e-6)
    fb = dsp.chroma_filterbank_for_tuning(tuning, SR, N_FFT)
    _close(fb, jax_dsp.chroma_filterbank_for_tuning(jnp.asarray(tuning.numpy()), SR, N_FFT, 12))
    _close(dsp.chroma_per_column(mag, _t(mask), SR, N_FFT), jax_dsp.chroma_per_column(jax_mag, jnp.asarray(mask), SR, N_FFT))


def test_spectral_contrast(spectra) -> None:
    mask = spectra["col_mask"]
    s_db = dsp.power_to_db_ref_max(spectra["mag"] ** 2, _t(mask))
    _close(
        dsp.spectral_contrast_per_column(s_db, _t(mask), SR, N_FFT),
        jax_dsp.spectral_contrast_per_column(jnp.asarray(s_db.numpy()), jnp.asarray(mask), SR, N_FFT),
    )


@pytest.mark.parametrize("masked", [False, True], ids=["pad_oblivious", "column_mask"])
def test_harmonic_mask_and_tonnetz(spectra, masked) -> None:
    mag = spectra["mag"][:, :400]
    mask = spectra["col_mask"] if masked else None
    jax_mask = None if mask is None else jnp.asarray(mask)
    _close(
        dsp.harmonic_mask(mag, col_mask=None if mask is None else _t(mask)),
        jax_dsp.harmonic_mask(jnp.asarray(mag.numpy()), col_mask=jax_mask),
    )
    _close(
        dsp.tonnetz_per_column(spectra["mag"], SR, N_FFT, col_mask=None if mask is None else _t(mask)),
        jax_dsp.tonnetz_per_column(jnp.asarray(spectra["mag"].numpy()), SR, N_FFT, col_mask=jax_mask),
    )


def test_median_filters_match_ser_tpu() -> None:
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 23)).astype(np.float32)
    for dim in (-1, -2):
        np.testing.assert_array_equal(
            dsp.median_filter_axis(_t(x), 31, dim).numpy(), np.asarray(jax_dsp._median_filter_axis(jnp.asarray(x), 31, dim))
        )
    mask = np.arange(23)[None, :] < np.array([[23], [9]])
    np.testing.assert_array_equal(
        dsp.median_filter_time_clamped(_t(x), 31, _t(mask)).numpy(),
        np.asarray(jax_dsp._median_filter_time_clamped(jnp.asarray(x), 31, jnp.asarray(mask))),
    )


@pytest.mark.parametrize("count", [1, 2, 6, 7, 0])
def test_masked_median_is_numpys(count) -> None:
    """An even count averages the two middle values (``torch.median`` returns the lower)."""
    rng = np.random.default_rng(count)
    values = rng.standard_normal((1, 12)).astype(np.float32)
    mask = np.zeros((1, 12), dtype=bool)
    mask[0, rng.permutation(12)[:count]] = True
    ours = dsp.masked_median(_t(values), _t(mask)).item()
    expected = float(np.median(values[mask])) if count else 0.0
    assert ours == pytest.approx(expected, abs=1e-7)
    assert ours == pytest.approx(float(jax_dsp._masked_median(jnp.asarray(values[0]), jnp.asarray(mask[0]))), abs=1e-7)
    if count % 2 == 0 and count:
        assert ours != pytest.approx(torch.from_numpy(values[mask]).median().item())


@pytest.mark.parametrize("clip_framed", [False, True], ids=["host_framed", "clip_framed"])
def test_feature_program_matches_ser_tpu(spectra, clip_framed) -> None:
    frames, lengths = spectra["frames"], spectra["lengths"]
    if clip_framed:
        clip = np.concatenate([frames[0], frames[1], frames[2]])
        starts = np.array([0, frames.shape[1], 2 * frames.shape[1]])
        kwargs = {"frame_length": frames.shape[1], "sr": SR}
        ours = dsp.handcrafted_features_clip(_t(clip), _t(starts), _t(lengths), **kwargs)
        reference = jax_dsp.handcrafted_features_clip(jnp.asarray(clip), jnp.asarray(starts, jnp.int32),
                                                      jnp.asarray(lengths, jnp.int32), **kwargs)
    else:
        ours = dsp.handcrafted_features_batch(_t(frames), _t(lengths), sr=SR)
        reference = jax_dsp.handcrafted_features_batch(jnp.asarray(frames), jnp.asarray(lengths, jnp.int32), sr=SR)
    assert tuple(ours.shape) == (3, 193)
    for family, (cols, _) in FAMILIES.items():
        _close(ours[:, cols], np.asarray(reference)[:, cols], rel=2e-5)


# --------------------------------------------------------------------------- #
# Goldens
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def goldens() -> dict:
    with np.load(FIXTURE) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def golden_features() -> dict:
    scripts = str(REPO / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import generate_dsp_fixtures as gen

    out = {}
    for sr in RATES:
        for name, signal in gen.signals(sr).items():
            features, starts, _ = extract_frame_features(signal, sr, device="cpu", feature_flags=FeatureFlags())
            assert starts[0] == 0.0
            out[(name, sr)] = features[0].astype(np.float64)
    return out


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("name", SIGNALS)
@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_feature_family_matches_golden(goldens, golden_features, name, sr, family) -> None:
    cols, atol = FAMILIES[family]
    golden = goldens[f"{name}_{sr}_{family}"]
    got = golden_features[(name, sr)][cols]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=GOLDEN_RTOL, atol=atol * max(1.0, np.abs(golden).max()))


# --------------------------------------------------------------------------- #
# Analytic oracles (the constructions of tests/suites/unit/ops/test_dsp_analytic.py)
# --------------------------------------------------------------------------- #


def _tone_magnitude(freq_hz: float, seconds: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    t = np.arange(int(seconds * SR)) / SR
    tone = np.sin(2 * np.pi * freq_hz * t).astype(np.float32)
    mag = dsp.stft_magnitude(torch.from_numpy(tone[None, :]), N_FFT, N_FFT // 4)
    return mag, torch.ones((1, mag.shape[-1]), dtype=torch.bool)


@pytest.mark.parametrize("detune_bins", [-0.30, -0.12, 0.0, 0.18, 0.25])
def test_estimate_tuning_recovers_known_detuning(detune_bins) -> None:
    mag, col_mask = _tone_magnitude(440.0 * 2.0 ** (detune_bins / 12.0))
    assert abs(dsp.estimate_tuning(mag, col_mask, SR, N_FFT).item() - detune_bins) < 0.05


@pytest.mark.parametrize("detune_bins", [0.12593324, 0.12593325])
def test_estimate_tuning_near_a_histogram_edge_matches_ser_tpu(detune_bins) -> None:
    """Tones on either side of the detune where the estimate steps from 0.10 to 0.11
    (0.1259332432, found by bisection): the histogram's mode sits on an edge there,
    so a last-bit difference may move it. One bin apart at most between the
    packages, and the chroma within its golden tolerance."""
    mag, col_mask = _tone_magnitude(440.0 * 2.0 ** (detune_bins / 12.0))
    jax_mag = jnp.asarray(mag.numpy())
    ours = dsp.estimate_tuning(mag, col_mask, SR, N_FFT).item()
    theirs = float(jax_dsp.estimate_tuning(jax_mag, jnp.asarray(col_mask.numpy()), SR, N_FFT)[0])
    assert abs(ours - theirs) <= 0.01 + 1e-6
    chroma = dsp.chroma_per_column(mag, col_mask, SR, N_FFT)
    reference = np.asarray(jax_dsp.chroma_per_column(jax_mag, jnp.asarray(col_mask.numpy()), SR, N_FFT))
    np.testing.assert_allclose(chroma.numpy(), reference, rtol=GOLDEN_RTOL, atol=FAMILIES["chroma"][1])


def test_estimate_tuning_silence_is_zero() -> None:
    mag = torch.zeros((1, 1 + N_FFT // 2, 8))
    assert dsp.estimate_tuning(mag, torch.ones((1, 8), dtype=torch.bool), SR, N_FFT).item() == 0.0


@pytest.mark.parametrize("freq_hz, pitch_class", [(440.0, 9), (261.6256, 0), (329.6276, 4)])
def test_chroma_argmax_is_the_tone_pitch_class(freq_hz, pitch_class) -> None:
    mag, col_mask = _tone_magnitude(freq_hz)
    interior = dsp.chroma_per_column(mag, col_mask, SR, N_FFT).numpy()[0, :, 2:-2]
    assert (interior.argmax(axis=0) == pitch_class).all()
    np.testing.assert_allclose(interior.max(axis=0), 1.0, atol=1e-6)


def test_harmonic_mask_closed_form_on_line_mixture() -> None:
    a, b = 3.0, 1.5
    mag = np.zeros((1, 64, 64), dtype=np.float32)
    mag[0, 30, :] = a
    mag[0, :, 40] = b
    mag[0, 30, 40] = a + b
    mask = dsp.harmonic_mask(_t(mag), kernel_size=31).numpy()
    np.testing.assert_allclose(mask[0, 30, 10], 1.0, atol=1e-6)
    np.testing.assert_allclose(mask[0, 10, 40], 0.0, atol=1e-6)
    np.testing.assert_allclose(mask[0, 30, 40], a**2 / (a**2 + b**2), atol=1e-5)
    np.testing.assert_allclose(mask[0, 10, 10], 0.0, atol=1e-6)


def test_harmonic_mask_respects_column_mask_at_signal_end() -> None:
    mag = np.zeros((1, 32, 64), dtype=np.float32)
    mag[0, 5, :40] = 2.0
    col_mask = _t(np.arange(64)[None, :] < 40)
    mask = dsp.harmonic_mask(_t(mag), kernel_size=31, col_mask=col_mask).numpy()
    np.testing.assert_allclose(mask[0, 5, :40], 1.0, atol=1e-6)


def test_spectral_contrast_two_level_bands_are_exact() -> None:
    s_db = np.empty((1, 1 + N_FFT // 2, 6), dtype=np.float32)
    s_db[0, 0::2, :] = 10.0
    s_db[0, 1::2, :] = 1000.0
    contrast = dsp.spectral_contrast_per_column(_t(s_db), torch.ones((1, 6), dtype=torch.bool), SR, N_FFT)
    assert contrast.shape[1] == 7
    np.testing.assert_allclose(contrast.numpy(), 20.0, atol=1e-4)


def test_spectral_contrast_constant_spectrum_is_zero() -> None:
    s_db = torch.full((1, 1 + N_FFT // 2, 4), 55.5)
    contrast = dsp.spectral_contrast_per_column(s_db, torch.ones((1, 4), dtype=torch.bool), SR, N_FFT)
    np.testing.assert_allclose(contrast.numpy(), 0.0, atol=1e-5)


def test_filter_constants_are_ser_tpus() -> None:
    from ser_tpu.ops import filters as jax_filters

    for name, args in (("dct_ii_ortho", (40, 128)), ("log_frequency_filterbank", (SR, N_FFT)),
                       ("cq_to_chroma_fold", ()), ("tonnetz_transform", ()), ("mel_filterbank", (SR, N_FFT))):
        np.testing.assert_array_equal(getattr(filters, name)(*args), getattr(jax_filters, name)(*args))
    assert filters.contrast_band_slices(SR, N_FFT) == jax_filters.contrast_band_slices(SR, N_FFT)
    for ours, theirs in zip(filters.chroma_base_bins(SR, N_FFT), jax_filters.chroma_base_bins(SR, N_FFT)):
        np.testing.assert_array_equal(ours, theirs)
