"""The port's profile catalog surface and the names that ride along with the CLI, against ``ser_tpu``.

- every field of every ``get_profile_catalog()`` entry, and the catalog's
  functions, aliases and classes, against ``ser_tpu.profiles`` (the port's
  catalog is Python data, ``ser_tpu``'s is YAML);
- ``predict_emotions`` and the medium framing constants, the artifact
  candidates of a models folder, ``artifact_profile_from_runtime_flags``,
  the phase labels, ``VectorFeatureBackend`` and the pipeline's transcript
  hook;
- legacy scikit-learn heads: a tiny ``MLPClassifier`` pickled bare and in an
  envelope loads into a ``TorchMLPClassifier`` with no scikit-learn code run,
  its probabilities within 1e-6 of scikit-learn's; any other estimator is
  refused.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import time

import numpy as np
import pytest

import ser_tpu.profiles as jax_profiles
from ser_tpu._internal.config import artifact_naming as jax_artifact_naming
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.models import emotion_model as jax_emotion_model
from ser_tpu._internal.repr import backend as jax_backend
from ser_tpu._internal.runtime import phases as jax_phases
from ser_tpu_torch import profiles
from ser_tpu_torch._internal.config import artifact_naming
from ser_tpu_torch._internal.models import artifacts, emotion_model
from ser_tpu_torch._internal.repr import VectorFeatureBackend
from ser_tpu_torch._internal.runtime import phases
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

#: Catalog fields that differ by design: the backends import torch, not jax and flax, and the fast
#: profile's description does not name a TPU kernel (ROADMAP.md, difference 36).
_BY_DESIGN = {("*", "required_modules"), ("fast", "description")}


@pytest.mark.parametrize("name", jax_profiles.PROFILE_NAMES)
def test_every_catalog_field_matches_ser_tpu(name) -> None:
    ours, theirs = profiles.get_profile_catalog()[name], jax_profiles.get_profile_catalog()[name]
    compared = 0
    for field in dataclasses.fields(theirs):
        if ("*", field.name) in _BY_DESIGN or (name, field.name) in _BY_DESIGN:
            continue
        value, reference = getattr(ours, field.name), getattr(theirs, field.name)
        if dataclasses.is_dataclass(reference):
            value, reference = dataclasses.asdict(value), dataclasses.asdict(reference)
        assert value == reference, field.name
        compared += 1
    assert compared == len(dataclasses.fields(theirs)) - (2 if name == "fast" else 1)
    assert ours.default_model_id == theirs.model.default_model_id
    assert ours.required_modules == (() if name == "fast" else ("torch",))


def test_catalog_functions_and_names_match_ser_tpu() -> None:
    assert list(profiles.get_profile_catalog()) == list(jax_profiles.get_profile_catalog())
    assert profiles.list_profile_names() == jax_profiles.list_profile_names()
    assert {k: dataclasses.asdict(v) for k, v in profiles.available_profiles().items() if k != "fast"} == {
        k: dataclasses.asdict(v) for k, v in jax_profiles.available_profiles().items() if k != "fast"}
    assert profiles.ProfileCatalogEntry is profiles.ProfileSpec
    assert profiles.ProfileModelDefinition is profiles.ProfileModelSpec
    assert issubclass(profiles.ProfileCatalogError, ValueError)
    with pytest.raises(profiles.ProfileCatalogError, match="Unknown profile"):
        profiles.require_ported("slow")  # type: ignore[arg-type]
    assert profiles.ProfileEnableFlag.__value__.__args__ == jax_profiles.ProfileEnableFlag.__value__.__args__
    assert profiles.TranscriptionBackendId.__value__.__args__ == jax_profiles.TranscriptionBackendId.__value__.__args__
    assert [f.name for f in dataclasses.fields(profiles.ProfileSpec)] == [
        f.name for f in dataclasses.fields(jax_profiles.ProfileSpec)]


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=3)))
def test_flag_resolution_matches_ser_tpu(flags) -> None:
    medium, accurate, research = flags

    class Settings:
        class runtime_flags:  # noqa: N801 - the attribute name the settings carry
            medium_profile, accurate_profile, accurate_research_profile = medium, accurate, research

    assert dataclasses.asdict(profiles.resolve_profile(Settings)).keys() == {"name", "description"}
    assert profiles.resolve_profile(Settings).name == jax_profiles.resolve_profile(Settings).name
    kwargs = {"medium_profile": medium, "accurate_profile": accurate, "accurate_research_profile": research}
    assert artifact_naming.artifact_profile_from_runtime_flags(**kwargs) == (
        jax_artifact_naming.artifact_profile_from_runtime_flags(**kwargs)) == profiles.resolve_profile_name(**kwargs)


def test_riding_names_match_ser_tpu() -> None:
    for name in ("MEDIUM_FRAME_SIZE_SECONDS", "MEDIUM_FRAME_STRIDE_SECONDS", "MEDIUM_POOLING_STRATEGY",
                 "FAST_FRAME_SIZE_SECONDS", "FAST_FRAME_STRIDE_SECONDS"):
        assert getattr(emotion_model, name) == getattr(jax_emotion_model, name)
    assert phases.ALL_PHASES == jax_phases.ALL_PHASES
    assert phases.PHASE_LABELS == jax_phases.PHASE_LABELS
    assert [phases.phase_label(p) for p in (*phases.ALL_PHASES, "custom")] == [
        jax_phases.phase_label(p) for p in (*jax_phases.ALL_PHASES, "custom")]

    class Vector:
        backend_id, feature_dim = "x", 3

        def encode_sequence(self, audio, sample_rate): ...

        def pool(self, encoded, windows): ...

        def extract_vector(self, audio, sample_rate): ...

    class Sequence(Vector):
        extract_vector = None

    for candidate in (Vector(), Sequence(), object()):
        assert isinstance(candidate, VectorFeatureBackend) == isinstance(candidate, jax_backend.VectorFeatureBackend)
    assert isinstance(Vector(), VectorFeatureBackend) and not isinstance(object(), VectorFeatureBackend)


def test_discover_artifact_candidates_matches_ser_tpu(tmp_path) -> None:
    assert artifacts.discover_artifact_candidates(tmp_path / "missing") == []
    for index, name in enumerate(("ser_model.pkl", "ser_model_accurate_x.pkl", "other.pkl", "ser_model.skops")):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (time.time() + index, time.time() + index))
    assert artifacts.discover_artifact_candidates(tmp_path) == jax_artifacts.discover_artifact_candidates(
        tmp_path) == [tmp_path / "ser_model_accurate_x.pkl", tmp_path / "ser_model.pkl"]
    assert artifacts.discover_artifact_candidates(tmp_path, "other") == [tmp_path / "other.pkl"]


def test_pipeline_transcript_hook_is_injectable(tmp_path) -> None:
    """The port's pipeline carries ``ser_tpu``'s ``transcript_fn`` field, called with the same arguments."""
    from ser_tpu_torch._internal.runtime import pipeline

    assert [f.name for f in dataclasses.fields(pipeline.RuntimePipeline)][:3] == [
        "settings", "backend_hooks", "transcript_fn"]
    assert pipeline.RuntimePipeline.__dataclass_fields__["transcript_fn"].default is pipeline._default_transcript_fn


# --------------------------------------------------------------------------- #
# Legacy scikit-learn heads
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def sklearn_neural_network():
    """scikit-learn's MLP module; only these tests skip where scikit-learn is missing."""
    return pytest.importorskip("sklearn.neural_network")


def _fitted(sklearn_neural_network, classes: int, seed: int):
    import warnings

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(60, 7))
    y = np.array(["angry", "happy", "neutral", "sad"][:classes])[rng.integers(0, classes, 60)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = sklearn_neural_network.MLPClassifier(hidden_layer_sizes=(6, 5), max_iter=40, random_state=seed)
        model.fit(X, y)
    return model, X


def _envelope(model) -> dict:
    metadata = jax_artifacts.build_artifact_metadata(feature_vector_size=7, training_samples=60,
                                                     labels=list(model.classes_))
    return jax_artifacts.build_model_artifact(model, metadata)


@pytest.mark.parametrize("wrapping", ["bare", "envelope"])
@pytest.mark.parametrize("classes", [4, 2], ids=["softmax", "logistic"])
@pytest.mark.parametrize("protocol", [2, pickle.HIGHEST_PROTOCOL], ids=["protocol2", "highest"])
def test_legacy_sklearn_head_matches_sklearn(sklearn_neural_network, tmp_path, wrapping, classes, protocol,
                                             monkeypatch) -> None:
    model, X = _fitted(sklearn_neural_network, classes, seed=classes)
    path = tmp_path / "ser_model.pkl"
    path.write_bytes(pickle.dumps(model if wrapping == "bare" else _envelope(model), protocol=protocol))
    # No scikit-learn code may run: its estimators cannot be found while the port loads.
    for cls in (sklearn_neural_network.MLPClassifier,):
        monkeypatch.setattr(cls, "__setstate__", lambda *_a: pytest.fail("sklearn code ran"), raising=False)
    loaded = artifacts.load_model_artifact(path, expected_profile="fast", device="cpu")
    monkeypatch.undo()
    assert isinstance(loaded.model, TorchMLPClassifier)
    assert loaded.expected_feature_size == (None if wrapping == "bare" else 7)
    np.testing.assert_allclose(loaded.model.predict_proba(X), model.predict_proba(X), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(loaded.model.predict(X), model.predict(X))
    reference = jax_artifacts.load_model_artifact(path).model
    np.testing.assert_allclose(loaded.model.predict_proba(X), reference.predict_proba(X), rtol=0, atol=1e-6)


@pytest.mark.parametrize("estimator", ["regressor", "tanh", "multilabel"])
def test_other_sklearn_estimators_are_refused(sklearn_neural_network, tmp_path, estimator) -> None:
    import warnings

    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if estimator == "regressor":
            model = sklearn_neural_network.MLPRegressor(hidden_layer_sizes=(3,), max_iter=5).fit(X, X[:, 0])
        elif estimator == "tanh":
            model = sklearn_neural_network.MLPClassifier(hidden_layer_sizes=(3,), activation="tanh",
                                                         max_iter=5).fit(X, rng.integers(0, 3, 30))
        else:
            model = sklearn_neural_network.MLPClassifier(hidden_layer_sizes=(3,), max_iter=5).fit(
                X, rng.integers(0, 2, (30, 3)))
    path = tmp_path / "ser_model.pkl"
    path.write_bytes(pickle.dumps(model))
    with pytest.raises(artifacts.ArtifactError):
        artifacts.load_model_artifact(path, device="cpu")
