"""The port's training loader and its split against ``ser_tpu``'s and scikit-learn's.

- ``split.train_test_indices`` against ``sklearn.model_selection.
  train_test_split`` (scikit-learn 1.9.0 here), index for index, over many
  seeds, sizes, class counts and test shares, stratified and not, with the
  same ``ValueError`` where scikit-learn raises; ``approximate_mode``
  against scikit-learn's, its tie draws included.
- ``loader.load_data`` on a small RAVDESS-named corpus (a corrupt file among
  them) in both packages: the same labels in the same order, each train and
  test row's features within the fast profile's golden tolerances
  (``tests/suites/unit/ops/test_dsp_golden_fixtures.py``: rtol 2e-3 and a
  per-family atol times max(1, |value|)); the failure budget refuses or
  admits the corrupt file alike; the unstratified fallback alike.
- ``discover_dataset_files``, ``load_utterances`` (glob and manifests) and
  ``apply_recipe_ledger`` (with the run state's stamped digests) alike.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from sklearn.model_selection import train_test_split
from sklearn.utils.extmath import _approximate_mode

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.data import loader as jax_loader
from ser_tpu._internal.data import manifest as jax_manifest
from ser_tpu._internal.models import training_orchestration as jax_orchestration
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.data import loader, manifest, split
from ser_tpu_torch._internal.models import training_orchestration
from ser_tpu_torch._internal.utils.audio_io import write_wav

FAMILIES = {
    "mfcc": (slice(0, 40), 2e-3),
    "chroma": (slice(40, 52), 5e-3),
    "mel": (slice(52, 180), 2e-4),
    "contrast": (slice(180, 187), 2e-3),
    "tonnetz": (slice(187, 193), 5e-3),
}
RTOL = 2e-3


def _split_outcome(fn):
    """The split, or that it raised ``ValueError`` (the condition is held; scikit-learn's
    parameter validation words an out-of-range ``test_size`` in its own way)."""
    try:
        return fn()
    except ValueError:
        return "ValueError"


def _ours(n, labels, test_size, seed, stratified):
    train, test = split.train_test_indices(n, test_size=test_size, random_state=seed,
                                           stratify=labels if stratified else None)
    return train.tolist(), test.tolist()


def _sklearn(n, labels, test_size, seed, stratified):
    train, test = train_test_split(np.arange(n), test_size=test_size, random_state=seed,
                                   stratify=labels if stratified else None)
    return train.tolist(), test.tolist()


@settings(max_examples=400, deadline=None)
@given(
    n=st.integers(2, 120),
    n_classes=st.integers(1, 9),
    seed=st.integers(0, 2**31 - 1),
    test_size=st.one_of(st.sampled_from([0.25, 0.1, 0.2, 0.33, 0.5, 0.75, 0.9, 0.0, 1.0]),
                        st.integers(-1, 40), st.floats(0.01, 0.99)),
    stratified=st.booleans(),
    data=st.data(),
)
def test_split_is_index_for_index_sklearn(n, n_classes, seed, test_size, stratified, data) -> None:
    codes = data.draw(st.lists(st.integers(0, n_classes - 1), min_size=n, max_size=n))
    labels = [f"class-{code}" for code in codes]
    ours = _split_outcome(lambda: _ours(n, labels, test_size, seed, stratified))
    theirs = _split_outcome(lambda: _sklearn(n, labels, test_size, seed, stratified))
    assert ours == theirs


@pytest.mark.parametrize("seed", range(8))
def test_split_on_ravdess_sized_corpora(seed: int) -> None:
    """1440 clips over 8 classes (RAVDESS's speech set) and an uneven corpus, the loader's defaults."""
    rng = np.random.default_rng(seed)
    for labels in ([f"e{i % 8}" for i in range(1440)], [f"e{int(v)}" for v in rng.integers(0, 5, 301)]):
        for stratified in (True, False):
            assert _ours(len(labels), labels, 0.25, 42 + seed, stratified) == _sklearn(
                len(labels), labels, 0.25, 42 + seed, stratified
            )


@settings(max_examples=300, deadline=None)
@given(counts=st.lists(st.integers(1, 30), min_size=1, max_size=9), seed=st.integers(0, 10**6), data=st.data())
def test_approximate_mode_matches_sklearn(counts, seed, data) -> None:
    class_counts = np.asarray(counts)
    n_draws = data.draw(st.integers(0, int(class_counts.sum())))
    ours = split.approximate_mode(class_counts, n_draws, np.random.RandomState(seed))
    theirs = _approximate_mode(class_counts, n_draws, np.random.RandomState(seed))
    np.testing.assert_array_equal(ours, theirs)


# --------------------------------------------------------------------------- #
# The loader, both packages
# --------------------------------------------------------------------------- #

EMOTIONS = {"01": 220.0, "03": 330.0, "04": 440.0, "05": 550.0}


def _write_corpus(root, *, actors: int = 2, clips: int = 3, corrupt: int = 1, lonely: bool = False) -> None:
    """RAVDESS-named 0.5 s clips at 16 kHz: a tone per class, noise per clip; ``corrupt`` bad headers."""
    sample_rate = 16000
    t = np.arange(sample_rate // 2) / sample_rate
    rng = np.random.default_rng(0)
    for actor in range(1, actors + 1):
        folder = root / f"Actor_{actor:02d}"
        folder.mkdir(parents=True, exist_ok=True)
        for code, freq in EMOTIONS.items():
            for clip in range(1, clips + 1):
                audio = 0.3 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(t.size)
                write_wav(folder / f"03-01-{code}-01-01-{clip:02d}-{actor:02d}.wav", audio.astype(np.float32), sample_rate)
    if lonely:  # a class of one clip: stratification is infeasible
        write_wav(root / "Actor_01" / "03-01-08-01-01-01-01.wav", (0.3 * np.sin(2 * np.pi * 660 * t)).astype(np.float32),
                  sample_rate)
    for index in range(corrupt):
        (root / "Actor_01" / f"03-01-01-01-02-{index + 1:02d}-01.wav").write_bytes(b"RIFX\x00\x00not a wave file")


def _settings_pair(root, **extra):
    env = {"SER_DATASET_FOLDER": str(root), "SER_TORCH_DEVICE": "cpu", "SER_MAX_WORKERS": "4", **extra}
    ours = build_settings(env)
    theirs = build_settings_from_inputs(capture_settings_inputs(env))
    # No retry delay on the corrupt files (AudioReadConfig: the same in both).
    ours = dataclasses.replace(ours, audio_read=dataclasses.replace(ours.audio_read, retry_delay_seconds=0.0))
    theirs = dataclasses.replace(theirs, audio_read=dataclasses.replace(theirs.audio_read, retry_delay_seconds=0.0))
    return ours, theirs


def _assert_features_close(ours: np.ndarray, theirs: np.ndarray) -> None:
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.float64
    for family, (cols, atol) in FAMILIES.items():
        np.testing.assert_allclose(ours[:, cols], theirs[:, cols], rtol=RTOL,
                                   atol=atol * max(1.0, float(np.abs(theirs[:, cols]).max())), err_msg=family)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    _write_corpus(root)
    return root


@pytest.fixture(scope="module")
def loaded(corpus):
    ours, theirs = _settings_pair(corpus, SER_MAX_FAILED_FILE_RATIO="0.2")
    return loader.load_data(settings=ours), jax_loader.load_data(settings=theirs)


def test_load_data_matches_ser_tpu(loaded) -> None:
    (x_train, x_test, y_train, y_test), (jx_train, jx_test, jy_train, jy_test) = loaded
    assert y_train == jy_train and y_test == jy_test
    assert len(y_train) + len(y_test) == 2 * 4 * 3  # the corrupt file skipped
    _assert_features_close(x_train, jx_train)
    _assert_features_close(x_test, jx_test)
    # Stratified: every class in both parts.
    assert set(y_train) == set(y_test) == {"neutral", "happy", "sad", "angry"}


def test_failure_budget_refuses_alike(corpus) -> None:
    ours, theirs = _settings_pair(corpus)  # the default 1 % budget
    with pytest.raises(RuntimeError) as ours_error:
        loader.load_labeled_clips(settings=ours)
    with pytest.raises(RuntimeError) as theirs_error:
        jax_loader.load_labeled_clips(settings=theirs)
    assert str(ours_error.value) == str(theirs_error.value)
    assert "SER_MAX_FAILED_FILE_RATIO" in str(ours_error.value)


def test_unstratified_fallback_matches_ser_tpu(tmp_path) -> None:
    _write_corpus(tmp_path, actors=1, clips=2, corrupt=0, lonely=True)
    ours, theirs = _settings_pair(tmp_path)
    a, b = loader.load_data(settings=ours), jax_loader.load_data(settings=theirs)
    assert a[2] == b[2] and a[3] == b[3] and "surprised" in a[2] + a[3]
    _assert_features_close(a[0], b[0])


def test_load_data_needs_two_classes_alike(tmp_path) -> None:
    folder = tmp_path / "Actor_01"
    folder.mkdir()
    t = np.arange(8000) / 16000
    for clip in range(3):
        write_wav(folder / f"03-01-03-01-01-{clip + 1:02d}-01.wav", np.sin(2 * np.pi * 300 * t).astype(np.float32), 16000)
    ours, theirs = _settings_pair(tmp_path)
    assert loader.load_data(settings=ours) is None and jax_loader.load_data(settings=theirs) is None
    empty = _settings_pair(tmp_path / "absent")
    assert loader.load_data(settings=empty[0]) is None and jax_loader.load_data(settings=empty[1]) is None


def _manifest_rows(package, corpus_root):
    files = sorted(corpus_root.glob("Actor_*/03-01-0[1345]-01-01-*.wav"))
    return [
        package.Utterance(
            sample_id=path.stem, corpus="ravdess", audio_path=str(path), label=label,
            speaker_id=f"ravdess:{path.stem.split('-')[-1]}",
            normalized_audio_sha256=hashlib.sha256(path.read_bytes()).hexdigest(), dataset_revision="1",
        )
        for path in files
        for label in [{"01": "neutral", "03": "happy", "04": "sad", "05": "angry"}[path.stem.split("-")[2]]]
    ]


def test_discovery_and_utterances_match_ser_tpu(corpus, tmp_path) -> None:
    ours, theirs = _settings_pair(corpus)
    assert loader.discover_dataset_files(ours) == jax_loader.discover_dataset_files(theirs)
    assert [u.to_record() for u in loader.load_utterances(settings=ours)] == [
        u.to_record() for u in jax_loader.load_utterances(settings=theirs)
    ]
    path = manifest.write_manifest_jsonl(_manifest_rows(manifest, corpus), tmp_path / "m.jsonl")
    ours, theirs = _settings_pair(tmp_path / "absent", SER_DATASET_MANIFESTS=path)
    assert [u.to_record() for u in loader.load_utterances(settings=ours)] == [
        u.to_record() for u in jax_loader.load_utterances(settings=theirs)
    ]
    assert loader.discover_dataset_files(ours) == jax_loader.discover_dataset_files(theirs)
    duplicate = tmp_path / "dup.jsonl"
    manifest.write_manifest_jsonl(_manifest_rows(manifest, corpus)[:2], duplicate)
    ours, theirs = _settings_pair(tmp_path / "absent", SER_DATASET_MANIFESTS=f"{path},{duplicate}")
    with pytest.raises(RuntimeError) as ours_error:
        loader.load_utterances(settings=ours)
    with pytest.raises(RuntimeError) as theirs_error:
        jax_loader.load_utterances(settings=theirs)
    assert str(ours_error.value) == str(theirs_error.value)


@pytest.mark.parametrize("strict", ["0", "1"])
def test_apply_recipe_ledger_matches_ser_tpu(corpus, strict: str) -> None:
    ours, theirs = _settings_pair(corpus, SER_DATASET_RECIPE="research-v1", SER_DATASET_STRICT_AUDIT=strict)
    with training_orchestration.training_operation_scope("fast") as run, \
            jax_orchestration.training_operation_scope("fast") as jax_run:
        kept = loader.apply_recipe_ledger(_manifest_rows(manifest, corpus), settings=ours)
        jax_kept = jax_loader.apply_recipe_ledger(_manifest_rows(jax_manifest, corpus), settings=theirs)
    assert [u.to_record() for u in kept] == [u.to_record() for u in jax_kept]
    assert {u.split for u in kept} <= {"train", "dev", "test"} and kept
    assert (run.recipe_digest, run.split_ledger_digest) == (jax_run.recipe_digest, jax_run.split_ledger_digest)
    assert run.recipe_digest is not None and training_orchestration.current_training_run() is None
