"""The training pipeline's splits, noise controls, sampling and multitask loss, against ``ser_tpu``.

- ``_internal/train/eval.py``: ``grouped_train_test_split``,
  ``speaker_independent_cv``, ``build_grouped_folds``,
  ``speaker_disjoint_split`` and ``stratified_group_folds`` give the same
  partitions as ``ser_tpu``'s (which draw with scikit-learn) for the same
  labels, speakers, shares and seeds (hypothesis), and raise alike;
- ``_internal/models/dataset_splitting.py``: the salted hash, the salt, the
  per-label hash split, and ``split_utterances`` / ``split_utterances_three_way``
  on each rung of the ladder (manifest, grouped, hash): the same members in the
  same order and the same metadata;
- ``_internal/models/noise_controls.py``: the same kept rows, indices and counts;
- ``_internal/models/utterance_sampling.py``: the same probabilities (exactly),
  window draws and contributions;
- ``models/multitask_loss.py`` (torch) against the JAX loss at rtol 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.data.manifest import Utterance as JaxUtterance
from ser_tpu._internal.models import dataset_splitting as jax_splitting
from ser_tpu._internal.models import noise_controls as jax_noise
from ser_tpu._internal.models import utterance_sampling as jax_sampling
from ser_tpu._internal.train import eval as jax_eval
from ser_tpu.models import multitask_loss as jax_loss
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.data.manifest import Utterance
from ser_tpu_torch._internal.models import dataset_splitting, noise_controls, utterance_sampling
from ser_tpu_torch._internal.train import eval as eval_
from ser_tpu_torch.models import multitask_loss

LOSS_RTOL = 1e-6

labels_and_speakers = st.integers(min_value=4, max_value=48).flatmap(
    lambda n: st.tuples(
        st.lists(st.sampled_from(["angry", "calm", "happy", "sad"]), min_size=n, max_size=n),
        st.lists(st.integers(min_value=0, max_value=9).map(lambda i: f"spk{i}"), min_size=n, max_size=n),
    )
)


def _outcome(fn):
    """``("ok", value)`` or ``("raises", type)``: both packages must agree on either."""
    try:
        return "ok", fn()
    except ValueError as err:
        return "raises", type(err)


def _same_indices(ours, theirs) -> None:
    assert ours[0] == theirs[0]
    if ours[0] == "raises":
        assert ours[1] is theirs[1]
        return
    assert len(ours[1]) == len(theirs[1])
    for (a_train, a_test), (b_train, b_test) in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(a_train, b_train)
        np.testing.assert_array_equal(a_test, b_test)


@settings(max_examples=60, deadline=None)
@given(data=labels_and_speakers, seed=st.integers(0, 2**31 - 1), test_size=st.floats(0.1, 0.6))
def test_grouped_train_test_split_matches_ser_tpu(data, seed, test_size) -> None:
    labels, speakers = data
    features = np.arange(len(labels), dtype=np.float64)[:, None]
    ours = _outcome(lambda: eval_.grouped_train_test_split(
        features, labels, speakers, test_size=test_size, random_state=seed))
    theirs = _outcome(lambda: jax_eval.grouped_train_test_split(
        features, labels, speakers, test_size=test_size, random_state=seed))
    assert ours[0] == theirs[0]
    if ours[0] == "ok":
        np.testing.assert_array_equal(ours[1].train_indices, theirs[1].train_indices)
        np.testing.assert_array_equal(ours[1].test_indices, theirs[1].test_indices)
        np.testing.assert_array_equal(ours[1].x_train, theirs[1].x_train)
        assert (ours[1].y_train, ours[1].y_test) == (theirs[1].y_train, theirs[1].y_test)
        assert not {speakers[i] for i in ours[1].train_indices} & {speakers[i] for i in ours[1].test_indices}


@pytest.mark.filterwarnings("ignore:The least populated class")
@settings(max_examples=60, deadline=None)
@given(data=labels_and_speakers, seed=st.integers(0, 2**31 - 1), n_splits=st.integers(2, 6))
def test_speaker_independent_cv_matches_ser_tpu(data, seed, n_splits) -> None:
    labels, speakers = data
    features = np.zeros((len(labels), 1))
    _same_indices(
        _outcome(lambda: eval_.speaker_independent_cv(features, labels, speakers, n_splits=n_splits,
                                                      random_state=seed)),
        _outcome(lambda: jax_eval.speaker_independent_cv(features, labels, speakers, n_splits=n_splits,
                                                         random_state=seed)),
    )


@pytest.mark.filterwarnings("ignore:The least populated class")
@settings(max_examples=40, deadline=None)
@given(data=labels_and_speakers, seed=st.integers(0, 2**31 - 1), n_splits=st.integers(2, 12))
def test_build_grouped_folds_ladder_matches_ser_tpu(data, seed, n_splits) -> None:
    labels, speakers = data
    ours = _outcome(lambda: eval_.build_grouped_folds(labels=labels, speaker_ids=speakers, n_splits=n_splits,
                                                      random_state=seed, fallback_test_size=0.25))
    theirs = _outcome(lambda: jax_eval.build_grouped_folds(labels=labels, speaker_ids=speakers, n_splits=n_splits,
                                                           random_state=seed, fallback_test_size=0.25))
    assert ours[0] == theirs[0]
    if ours[0] == "ok":
        assert ours[1][0] == theirs[1][0]
        _same_indices(("ok", ours[1][1]), ("ok", theirs[1][1]))


@pytest.mark.filterwarnings("ignore:The least populated class")
@settings(max_examples=60, deadline=None)
@given(data=labels_and_speakers, seed=st.integers(0, 2**31 - 1), with_labels=st.booleans(),
       one_speaker=st.booleans())
def test_item_level_splits_match_ser_tpu(data, seed, with_labels, one_speaker) -> None:
    labels, speakers = data
    items = [(f"clip{i}.wav", label, "spk0" if one_speaker else speaker)
             for i, (label, speaker) in enumerate(zip(labels, speakers))]
    kwargs = dict(speaker_of=lambda item: item[2], label_of=(lambda item: item[1]) if with_labels else None)
    ours = _outcome(lambda: eval_.speaker_disjoint_split(items, test_size=0.25, random_state=seed, **kwargs))
    theirs = _outcome(lambda: jax_eval.speaker_disjoint_split(items, test_size=0.25, random_state=seed, **kwargs))
    assert ours == theirs
    ours = _outcome(lambda: eval_.stratified_group_folds(items, n_folds=4, random_state=seed, **kwargs))
    theirs = _outcome(lambda: jax_eval.stratified_group_folds(items, n_folds=4, random_state=seed, **kwargs))
    assert ours == theirs


def test_speaker_id_and_input_validation_match_ser_tpu() -> None:
    for name in ("03-01-05-01-02-01-12.wav", "a/b/03-01-05-01-02-01-07.flac", "short-name.wav", "1-2-3-4-5-6-.wav"):
        assert eval_.extract_ravdess_speaker_id(name) == jax_eval.extract_ravdess_speaker_id(name)
    bad_calls = [
        lambda m: m.grouped_train_test_split(np.zeros(3), ["a"] * 3, ["s", "t", "u"], test_size=0.3, random_state=0),
        lambda m: m.grouped_train_test_split(np.zeros((3, 1)), ["a"] * 3, ["s"] * 3, test_size=0.3, random_state=0),
        lambda m: m.grouped_train_test_split(np.zeros((3, 1)), ["a"] * 2, ["s", "t", "u"], test_size=0.3,
                                             random_state=0),
        lambda m: m.grouped_train_test_split(np.zeros((3, 1)), ["a"] * 3, ["s", "t", "u"], test_size=1.0,
                                             random_state=0),
        lambda m: m.speaker_independent_cv(np.zeros((4, 1)), ["a"] * 4, list("stuv"), n_splits=1),
        lambda m: m.speaker_disjoint_split([], speaker_of=str),
        lambda m: m.speaker_disjoint_split(["x"], speaker_of=str, test_size=0.0),
        lambda m: m.speaker_disjoint_split(["only"], speaker_of=lambda _: "s"),
        lambda m: m.stratified_group_folds(["a", "b"], speaker_of=lambda _: "s"),
    ]
    for call in bad_calls:
        ours, theirs = _outcome(lambda: call(eval_)), _outcome(lambda: call(jax_eval))
        assert ours[0] == theirs[0] == "raises"
        assert str(_message(call, eval_)) == str(_message(call, jax_eval))


def _message(call, module) -> str:
    try:
        call(module)
    except ValueError as err:
        return str(err)
    raise AssertionError("expected a ValueError")


# --------------------------------------------------------------------------- #
# dataset_splitting
# --------------------------------------------------------------------------- #


def _settings_pair(env: dict):
    return build_settings(env), build_settings_from_inputs(capture_settings_inputs(env))


def _utterances(rng, n: int, *, corpora=("ravdess", "crema"), speakers: bool = True, splits=None):
    rows = []
    for i in range(n):
        corpus = corpora[i % len(corpora)]
        actor = int(rng.integers(1, 7))
        path = f"/data/{corpus}/Actor_{actor:02d}/03-01-{int(rng.integers(1, 5)):02d}-01-01-01-{actor:02d}.wav"
        rows.append(dict(
            sample_id=f"{corpus}-{i:03d}",
            corpus=corpus,
            audio_path=path,
            label=["angry", "calm", "happy", "sad"][int(rng.integers(0, 4))],
            speaker_id=(f"{corpus}:{actor}" if speakers else None),
            language="en",
            split=None if splits is None else splits[i % len(splits)],
        ))
    return [Utterance(**row) for row in rows], [JaxUtterance(**row) for row in rows]


def _ids(partition) -> list[str]:
    return [utterance.sample_id for utterance in partition]


@pytest.mark.parametrize(
    "case",
    ["grouped", "hash-no-speakers", "hash-non-ravdess", "manifest", "manifest-incomplete", "three-way-native"],
)
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_split_utterances_ladder_matches_ser_tpu(case, seed, monkeypatch) -> None:
    monkeypatch.delenv("SER_SPLIT_SALT", raising=False)
    rng = np.random.default_rng(seed)
    kwargs: dict = {}
    if case == "hash-no-speakers":
        kwargs = dict(speakers=False, corpora=("crema",))
    elif case == "hash-non-ravdess":
        kwargs = dict(speakers=False, corpora=("crema", "iemocap"))
    elif case == "manifest":
        kwargs = dict(splits=("train", "dev", "test", "train"))
    elif case == "manifest-incomplete":
        kwargs = dict(splits=("train", "dev"))
    elif case == "three-way-native":
        kwargs = dict(splits=("train", "dev", "test"))
    ours_u, theirs_u = _utterances(rng, 40, **kwargs)
    ours_s, theirs_s = _settings_pair({"SER_RANDOM_STATE": str(seed), "SER_DEV_SIZE": "0.15"})
    train, test, meta = dataset_splitting.split_utterances(samples=ours_u, settings=ours_s)
    j_train, j_test, j_meta = jax_splitting.split_utterances(samples=theirs_u, settings=theirs_s)
    assert (_ids(train), _ids(test)) == (_ids(j_train), _ids(j_test))
    assert meta.as_dict() == j_meta.as_dict()
    three = dataset_splitting.split_utterances_three_way(samples=ours_u, settings=ours_s)
    j_three = jax_splitting.split_utterances_three_way(samples=theirs_u, settings=theirs_s)
    assert [_ids(part) for part in three[:3]] == [_ids(part) for part in j_three[:3]]
    assert three[3].as_dict() == j_three[3].as_dict()


@settings(max_examples=50, deadline=None)
@given(
    labels=st.lists(st.sampled_from(["a", "b", "c"]), min_size=1, max_size=30),
    salt=st.text(min_size=0, max_size=12),
    test_size=st.floats(0.05, 0.95),
)
def test_hash_stratified_split_matches_ser_tpu(labels, salt, test_size) -> None:
    rows = [dict(sample_id=f"s{i}", corpus="c", audio_path=f"/x/s{i}.wav", label=label)
            for i, label in enumerate(labels)]
    ours = dataset_splitting.hash_stratified_split(samples=[Utterance(**r) for r in rows], test_size=test_size,
                                                   salt=salt)
    theirs = jax_splitting.hash_stratified_split(samples=[JaxUtterance(**r) for r in rows], test_size=test_size,
                                                 salt=salt)
    assert (_ids(ours[0]), _ids(ours[1])) == (_ids(theirs[0]), _ids(theirs[1]))
    for sample_id in ("s0", "ravdess:03-01-01", ""):
        assert dataset_splitting.hash_for_split(sample_id, salt=salt) == jax_splitting.hash_for_split(
            sample_id, salt=salt)


def test_split_salt_and_speaker_scoping_match_ser_tpu(monkeypatch) -> None:
    ours_s, theirs_s = _settings_pair({"SER_RANDOM_STATE": "9"})
    monkeypatch.delenv("SER_SPLIT_SALT", raising=False)
    assert dataset_splitting.split_salt(ours_s) == jax_splitting.split_salt(theirs_s) == "ser:9"
    monkeypatch.setenv("SER_SPLIT_SALT", "  pinned ")
    assert dataset_splitting.split_salt(ours_s) == jax_splitting.split_salt(theirs_s) == "pinned"
    for row in (
        dict(sample_id="a", corpus="ravdess", audio_path="/d/Actor_03/03-01-01-01-01-01-03.wav"),
        dict(sample_id="b", corpus="ravdess", audio_path="/d/odd.wav"),
        dict(sample_id="c", corpus="crema", audio_path="/d/Actor_03/03-01-01-01-01-01-03.wav"),
        dict(sample_id="d", corpus="crema", audio_path="/d/x.wav", speaker_id="crema:7"),
    ):
        assert dataset_splitting.resolve_corpus_scoped_speaker_id(Utterance(**row)) == (
            jax_splitting.resolve_corpus_scoped_speaker_id(JaxUtterance(**row)))
    one = [Utterance(sample_id="a", corpus="c", audio_path="/a.wav", label="x")]
    with pytest.raises(RuntimeError, match="at least two"):
        dataset_splitting.split_utterances(samples=one, settings=ours_s)


# --------------------------------------------------------------------------- #
# noise_controls, utterance_sampling
# --------------------------------------------------------------------------- #


@settings(max_examples=80, deadline=None)
@given(
    rows=st.integers(1, 40),
    half=st.integers(1, 8),
    seed=st.integers(0, 2**31 - 1),
    min_std=st.sampled_from([0.0, 0.05, 0.5, 0.9, 5.0]),
    cap=st.integers(0, 12),
)
def test_noise_controls_match_ser_tpu(rows, half, seed, min_std, cap) -> None:
    rng = np.random.default_rng(seed)
    pooled = np.concatenate([rng.standard_normal((rows, half)), np.abs(rng.standard_normal((rows, half)))], axis=1)
    kept, indices, stats = noise_controls.apply_noise_controls(pooled, min_window_std=min_std,
                                                               max_windows_per_clip=cap)
    j_kept, j_indices, j_stats = jax_noise.apply_noise_controls(pooled, min_window_std=min_std,
                                                                max_windows_per_clip=cap)
    np.testing.assert_array_equal(kept, j_kept)
    np.testing.assert_array_equal(indices, j_indices)
    assert stats.as_dict() == j_stats.as_dict()
    merged = stats.merged(stats)
    assert merged.as_dict() == j_stats.merged(j_stats).as_dict()


def test_noise_controls_refuse_what_ser_tpu_refuses() -> None:
    for bad in (np.zeros((0, 4)), np.zeros((3, 3)), np.zeros(4), np.zeros((2, 0))):
        with pytest.raises(RuntimeError) as ours:
            noise_controls.apply_noise_controls(bad, min_window_std=0.1, max_windows_per_clip=2)
        with pytest.raises(RuntimeError) as theirs:
            jax_noise.apply_noise_controls(bad, min_window_std=0.1, max_windows_per_clip=2)
        assert str(ours.value) == str(theirs.value)


@settings(max_examples=40, deadline=None)
@given(
    cells=st.lists(
        st.tuples(st.sampled_from(["ravdess", "crema", "msp"]), st.sampled_from(["angry", "sad", "neutral"]),
                  st.integers(1, 9), st.one_of(st.none(), st.floats(0.5, 20.0))),
        min_size=1, max_size=25,
    ),
    seed=st.integers(0, 1000),
    epoch=st.integers(0, 5),
)
def test_utterance_sampling_matches_ser_tpu(cells, seed, epoch) -> None:
    rows = [dict(sample_id=f"id{i}", corpus=c, label=label, window_count=w, duration_seconds=d)
            for i, (c, label, w, d) in enumerate(cells)]
    ours = [utterance_sampling.UtteranceSamplingItem(**row) for row in rows]
    theirs = [jax_sampling.UtteranceSamplingItem(**row) for row in rows]
    assert [dataclasses.astuple(r) for r in utterance_sampling.utterance_sampling_distribution(ours)] == [
        dataclasses.astuple(r) for r in jax_sampling.utterance_sampling_distribution(theirs)]
    assert utterance_sampling.sampling_contributions(ours) == jax_sampling.sampling_contributions(theirs)
    for row in rows:
        for max_windows in (1, 3, 8):
            assert utterance_sampling.select_training_windows(
                sample_id=row["sample_id"], window_count=row["window_count"], max_windows=max_windows,
                seed=seed, epoch=epoch,
            ) == jax_sampling.select_training_windows(
                sample_id=row["sample_id"], window_count=row["window_count"], max_windows=max_windows,
                seed=seed, epoch=epoch,
            )


def test_utterance_sampling_refuses_what_ser_tpu_refuses() -> None:
    bad_items = [
        [],
        [dict(sample_id=" ", corpus="c", label="l", window_count=1)],
        [dict(sample_id="a", corpus="c", label="l", window_count=0)],
        [dict(sample_id="a", corpus="c", label="l", window_count=1, duration_seconds=0.0)],
        [dict(sample_id="a", corpus="c", label="l", window_count=1)] * 2,
    ]
    for rows in bad_items:
        with pytest.raises(ValueError) as ours:
            utterance_sampling.utterance_sampling_distribution(
                [utterance_sampling.UtteranceSamplingItem(**r) for r in rows])
        with pytest.raises(ValueError) as theirs:
            jax_sampling.utterance_sampling_distribution([jax_sampling.UtteranceSamplingItem(**r) for r in rows])
        assert str(ours.value) == str(theirs.value)
    for kwargs in (dict(sample_id="", window_count=3, max_windows=2, seed=0),
                   dict(sample_id="a", window_count=0, max_windows=2, seed=0),
                   dict(sample_id="a", window_count=3, max_windows=2, seed=0, epoch=-1)):
        with pytest.raises(ValueError):
            utterance_sampling.select_training_windows(**kwargs)
        with pytest.raises(ValueError):
            jax_sampling.select_training_windows(**kwargs)


# --------------------------------------------------------------------------- #
# multitask_loss
# --------------------------------------------------------------------------- #

TASKS = ("primary_emotion", "vad", "social_attitude")


@settings(max_examples=60, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n=st.integers(1, 12),
    present=st.lists(st.sampled_from(TASKS), min_size=1, max_size=3, unique=True),
    empty=st.sampled_from([None, *TASKS]),
    log_scale=st.floats(-3.0, 3.0),
    minimum=st.sampled_from([0.25, 0.5, 1.0]),
)
def test_multitask_loss_matches_ser_tpu(seed, n, present, empty, log_scale, minimum) -> None:
    rng = np.random.default_rng(seed)
    log_variances = {task: np.float32(log_scale * rng.uniform(-1, 1)) for task in TASKS}
    losses = {task: np.abs(rng.standard_normal(n)).astype(np.float32) for task in present}
    masks = {task: (rng.uniform(size=n) < 0.6).astype(np.float32) for task in present}
    if empty in masks:
        masks[empty][:] = 0.0
    ours_params = multitask_loss.init_multitask_loss_params(TASKS)
    theirs_params = jax_loss.init_multitask_loss_params(TASKS)
    assert list(ours_params["log_variances"]) == list(theirs_params["log_variances"])
    ours_params = {"log_variances": {t: torch.tensor(v) for t, v in log_variances.items()}}
    theirs_params = {"log_variances": {t: jnp.asarray(v) for t, v in log_variances.items()}}
    ours = multitask_loss.multitask_loss(
        ours_params, {t: torch.from_numpy(v) for t, v in losses.items()},
        {t: torch.from_numpy(v) for t, v in masks.items()}, minimum_primary_weight=minimum)
    theirs = jax_loss.multitask_loss(
        theirs_params, {t: jnp.asarray(v) for t, v in losses.items()},
        {t: jnp.asarray(v) for t, v in masks.items()}, minimum_primary_weight=minimum)
    assert ours.dtype == torch.float32 and ours.shape == ()
    np.testing.assert_allclose(float(ours), float(theirs), rtol=LOSS_RTOL, atol=1e-7)


def test_multitask_loss_gradient_and_contracts() -> None:
    params = multitask_loss.init_multitask_loss_params(["primary_emotion", "vad"])
    for value in params["log_variances"].values():
        value.requires_grad_()
    loss = multitask_loss.multitask_loss(
        params,
        {"primary_emotion": torch.tensor([1.0, 3.0]), "vad": torch.tensor(2.0)},
        {"primary_emotion": torch.tensor([1.0, 1.0]), "vad": torch.tensor(1.0)},
    )
    loss.backward()
    # d/ds (e^-s m + s) at s = 0 is 1 - m.
    assert float(params["log_variances"]["primary_emotion"].grad) == pytest.approx(1.0 - 2.0)
    assert float(params["log_variances"]["vad"].grad) == pytest.approx(1.0 - 2.0)
    for tasks in ([], [" ", ""], ["a.b"]):
        with pytest.raises(ValueError) as ours:
            multitask_loss.normalize_task_names(tasks)
        with pytest.raises(ValueError) as theirs:
            jax_loss.normalize_task_names(tasks)
        assert str(ours.value) == str(theirs.value)
    assert multitask_loss.normalize_task_names([" a ", "b", "a"]) == jax_loss.normalize_task_names([" a ", "b", "a"])
    with pytest.raises(ValueError, match="No available targets"):
        multitask_loss.validate_multitask_inputs(params, {"other": 1}, {"other": 1})
    with pytest.raises(ValueError, match="shapes differ"):
        multitask_loss.multitask_loss(params, {"vad": torch.ones(2)}, {"vad": torch.ones(3)})
    with pytest.raises(ValueError, match="minimum_primary_weight"):
        multitask_loss.multitask_loss(params, {}, {}, minimum_primary_weight=0.0)
    assert float(multitask_loss.multitask_loss(params, {}, {})) == 0.0
