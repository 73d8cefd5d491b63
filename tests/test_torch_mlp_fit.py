"""The fast head's trainer, its artifacts and the SER metrics of the port, against ``ser_tpu``.

- ``TorchMLPClassifier.fit_from`` (the training loop) given the JAX head's
  initial layers and epoch permutations, computed here with ``jax.random``
  exactly as ``JaxMLPClassifier.fit`` draws them, against
  ``JaxMLPClassifier.fit`` end to end: the same ``n_iter_``, ``loss_`` at
  rtol 1e-5, weights and biases at rtol 1e-4 (atol 1e-6 times the layer's
  largest value), and the same predictions; over hidden widths, batch sizes
  (``"auto"``, padded last batches), alphas and seeds.
- ``fit`` draws Glorot-uniform weights and permutations from seeded
  generators: the same seed gives the same head, another seed another; it
  separates separable data; bad inputs raise as the JAX head's do.
- Artifacts: the port's envelope loads in ``ser_tpu``'s
  ``load_model_artifact`` and ``ser_tpu``'s in the port's, with the same
  predictions and metadata; the ``.meta.json`` sidecar and the file's
  permissions are the JAX package's; bad digests are refused alike.
- ``compute_ser_metrics``, ``accuracy`` and the per-sample metrics equal
  ``ser_tpu``'s on the same labels.
"""

from __future__ import annotations

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.config.schema import NeuralNetConfig as JaxNeuralNetConfig
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.train import metrics as jax_metrics
from ser_tpu.models.mlp_head import JaxMLPClassifier
from ser_tpu_torch._internal.config.schema import NeuralNetConfig
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.train import metrics
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
PARAM_ATOL_SCALE = 1e-6


def _data(seed: int, n: int, n_features: int, n_classes: int, spread: float = 2.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, n_features)) * spread
    codes = rng.integers(0, n_classes, n)
    codes[:n_classes] = np.arange(n_classes)  # every class present
    X = (centers[codes] + rng.standard_normal((n, n_features))).astype(np.float32)
    labels = np.array([f"class-{c}" for c in range(n_classes)])[codes]
    return X, labels


def _jax_initial_layers(dims: list[int], random_state: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``JaxMLPClassifier.fit``'s initial parameters, drawn as it draws them."""
    key = jax.random.PRNGKey(random_state)
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        key, sub = jax.random.split(key)
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        weight = jax.random.uniform(sub, (fan_in, fan_out), minval=-bound, maxval=bound, dtype=jnp.float32)
        layers.append((np.asarray(weight), np.zeros(fan_out, dtype=np.float32)))
    return layers


class _JaxPermutations:
    """``JaxMLPClassifier.fit``'s epoch permutations, in order."""

    def __init__(self, random_state: int, padded: int) -> None:
        self._key = jax.random.PRNGKey(random_state + 1)
        self.drawn = 0

        def draw(key):
            key, sub = jax.random.split(key)
            return key, jax.random.permutation(sub, padded)

        self._draw = jax.jit(draw)  # the same bits as the eager calls, without a dispatch per op

    def __call__(self, epoch: int) -> np.ndarray:
        assert epoch == self.drawn
        self._key, permutation = self._draw(self._key)
        self.drawn += 1
        return np.asarray(permutation)


FIT_CASES = {
    "default-width": dict(n=150, features=24, classes=4, kw=dict(hidden_layer_sizes=(300,), batch_size=256,
                                                                    max_iter=80, random_state=42)),
    "padded-batches": dict(n=90, features=12, classes=3, kw=dict(hidden_layer_sizes=(16,), batch_size=32,
                                                                   max_iter=200, random_state=3)),
    "auto-batch-two-layers": dict(n=230, features=10, classes=5, kw=dict(hidden_layer_sizes=(32, 16),
                                                                           batch_size="auto", max_iter=60,
                                                                           random_state=7, alpha=0.1)),
    "strong-alpha": dict(n=64, features=8, classes=2, kw=dict(hidden_layer_sizes=(8,), batch_size=16, max_iter=400,
                                                              random_state=11, alpha=1.0)),
}


@pytest.fixture(scope="module", params=sorted(FIT_CASES))
def fitted_pair(request):
    case = FIT_CASES[request.param]
    X, y = _data(len(request.param), case["n"], case["features"], case["classes"])
    theirs = JaxMLPClassifier(**case["kw"]).fit(X, y)
    ours = TorchMLPClassifier(**case["kw"], device="cpu")
    batch, padded = ours.batch_rows(X.shape[0])
    permutations = _JaxPermutations(case["kw"]["random_state"], padded)
    ours.fit_from(X, y, layers=_jax_initial_layers(ours.layer_dims(X.shape[1], case["classes"]),
                                                   case["kw"]["random_state"]), permutation=permutations)
    return ours, theirs, X, y, permutations


def test_inner_loop_stops_where_jax_does(fitted_pair) -> None:
    ours, theirs, *_, permutations = fitted_pair
    assert ours.n_iter_ == theirs.n_iter_ == permutations.drawn
    np.testing.assert_allclose(ours.loss_, theirs.loss_, rtol=LOSS_RTOL)


def test_inner_loop_parameters_match_jax(fitted_pair) -> None:
    ours, theirs, *_ = fitted_pair
    ours_state, theirs_state = ours.get_state(), theirs.get_state()
    for name in ("weights", "biases"):
        for a, b in zip(ours_state[name], theirs_state[name], strict=True):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL_SCALE * float(np.abs(b).max()))


def test_inner_loop_predictions_match_jax(fitted_pair) -> None:
    ours, theirs, X, y, _ = fitted_pair
    np.testing.assert_array_equal(ours.classes_, theirs.classes_)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    np.testing.assert_allclose(ours.predict_proba(X), theirs.predict_proba(X), rtol=1e-4, atol=1e-6)


def test_state_round_trips_and_matches_jax_keys(fitted_pair) -> None:
    ours, theirs, X, *_ = fitted_pair
    state = ours.get_state()
    assert sorted(state) == sorted(theirs.get_state())
    assert all(not isinstance(value, np.generic) for value in (state["n_iter"], state["loss"]))
    again = TorchMLPClassifier.from_state(state, device="cpu")
    np.testing.assert_array_equal(again.decision_function(X), ours.decision_function(X))
    assert (again.n_iter_, again.loss_, again.hidden_layer_sizes) == (ours.n_iter_, ours.loss_, ours.hidden_layer_sizes)
    np.testing.assert_array_equal(JaxMLPClassifier.from_state(state).predict(X), ours.predict(X))


def test_from_config_reads_the_settings(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    config = NeuralNetConfig()
    ours = TorchMLPClassifier.from_config(config)
    theirs = JaxMLPClassifier.from_config(JaxNeuralNetConfig())
    for name in ("hidden_layer_sizes", "alpha", "batch_size", "epsilon", "max_iter", "random_state",
                 "learning_rate_init", "tol", "n_iter_no_change"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device == torch.device("cpu")


@pytest.mark.parametrize("setting", [None, "auto", "cuda", "cpu"])
def test_from_config_takes_the_settings_device(monkeypatch: pytest.MonkeyPatch, setting: str | None) -> None:
    """With no ``device``, the head goes where ``SER_TORCH_DEVICE`` says: the card unless it says cpu."""
    if setting is None:
        monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("SER_TORCH_DEVICE", setting)
    if setting == "cpu":
        assert TorchMLPClassifier.from_config(NeuralNetConfig()).device == torch.device("cpu")
    elif torch.cuda.is_available():
        assert TorchMLPClassifier.from_config(NeuralNetConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
            TorchMLPClassifier.from_config(NeuralNetConfig())
    # An explicit device wins over the settings.
    assert TorchMLPClassifier.from_config(NeuralNetConfig(), device="cpu").device == torch.device("cpu")


def test_seeded_fit_is_deterministic_and_separates() -> None:
    X, y = _data(5, 120, 16, 4, spread=3.0)
    kw = dict(hidden_layer_sizes=(32,), batch_size=40, max_iter=150, random_state=9)
    first = TorchMLPClassifier(**kw, device="cpu").fit(X, y)
    second = TorchMLPClassifier(**kw, device="cpu").fit(X, y)
    other = TorchMLPClassifier(**{**kw, "random_state": 10}, device="cpu").fit(X, y)
    np.testing.assert_array_equal(first.get_state()["weights"][0], second.get_state()["weights"][0])
    assert not np.array_equal(first.get_state()["weights"][0], other.get_state()["weights"][0])
    assert np.mean(first.predict(X) == y) >= 0.95


def test_seeded_initial_layers_are_glorot_uniform() -> None:
    X, y = _data(6, 40, 30, 3)
    seen = {}

    class _Recording(TorchMLPClassifier):
        def _train(self, X, y_idx, layers, permutation):
            seen["layers"], seen["perms"] = layers, [permutation(e) for e in range(3)]
            return self

    _Recording(hidden_layer_sizes=(50,), batch_size=16, random_state=1, device="cpu").fit(X, y)
    for (weight, bias), (fan_in, fan_out) in zip(seen["layers"], [(30, 50), (50, 3)]):
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        assert tuple(weight.shape) == (fan_in, fan_out) and float(weight.abs().max()) <= bound
        assert float(weight.abs().max()) > 0.9 * bound and float(bias.abs().max()) == 0.0
    for perm in seen["perms"]:
        assert sorted(perm.tolist()) == list(range(48))  # 3 batches of 16 cover 40 rows
    assert not np.array_equal(seen["perms"][0], seen["perms"][1])


@pytest.mark.parametrize("case", ["one-class", "length-mismatch", "empty", "not-2d"])
def test_bad_inputs_raise_like_jax(case: str) -> None:
    X, y = _data(1, 10, 4, 2)
    args = {"one-class": (X, ["a"] * 10), "length-mismatch": (X, y[:5]), "empty": (X[:0], y[:0]),
            "not-2d": (X[:, 0], y)}[case]
    with pytest.raises(ValueError) as ours:
        TorchMLPClassifier(max_iter=2, device="cpu").fit(*args)
    with pytest.raises(ValueError) as theirs:
        JaxMLPClassifier(max_iter=2).fit(*args)
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------------- #
# Artifacts across packages
# --------------------------------------------------------------------------- #


def _metadata(package, **extra):
    return package.build_artifact_metadata(
        feature_vector_size=24, training_samples=150, labels=["class-0", "class-1", "class-2", "class-3"],
        provenance={"trainer": "test"}, seed=42, evaluation_summary={"uar": 0.5}, **extra,
    )


def test_metadata_matches_ser_tpu() -> None:
    digests = dict(recipe_digest="a" * 64, split_ledger_digest="b" * 64)
    for extra in ({}, digests):
        ours, theirs = _metadata(artifacts, **extra), _metadata(jax_artifacts, **extra)
        ours.pop("created_at_utc"), theirs.pop("created_at_utc")
        assert list(ours) == list(theirs) and ours == theirs


@pytest.mark.parametrize("bad", [dict(recipe_digest="A" * 64), dict(split_ledger_digest="xyz"),
                                 dict(feature_vector_size=0), dict(training_samples=0), dict(labels=[])])
def test_metadata_refuses_alike(bad) -> None:
    base = dict(feature_vector_size=24, training_samples=150, labels=["a", "b"])
    with pytest.raises(artifacts.ArtifactError) as ours:
        artifacts.build_artifact_metadata(**{**base, **bad})
    with pytest.raises(jax_artifacts.ArtifactError) as theirs:
        jax_artifacts.build_artifact_metadata(**{**base, **bad})
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("writer", ["port", "ser_tpu"])
def test_artifacts_load_across_packages(tmp_path, fitted_pair, writer: str) -> None:
    ours, theirs, X, *_ = fitted_pair
    path = tmp_path / "models" / "ser_model.pkl"
    n_features = X.shape[1]
    if writer == "port":
        metadata = artifacts.build_artifact_metadata(feature_vector_size=n_features, training_samples=len(X),
                                                     labels=ours.classes_.tolist())
        artifacts.save_model_artifact(artifacts.build_model_artifact(ours, metadata), path)
        loaded = jax_artifacts.load_model_artifact(path, expected_backend_id="handcrafted", expected_profile="fast")
        assert isinstance(loaded.model, JaxMLPClassifier)
        np.testing.assert_array_equal(loaded.model.predict(X), ours.predict(X))
        np.testing.assert_array_equal(loaded.model.decision_function(X), JaxMLPClassifier.from_state(
            ours.get_state()).decision_function(X))
    else:
        metadata = jax_artifacts.build_artifact_metadata(feature_vector_size=n_features, training_samples=len(X),
                                                         labels=theirs.classes_.tolist())
        jax_artifacts.save_model_artifact(jax_artifacts.build_model_artifact(theirs, metadata), path)
        loaded = artifacts.load_model_artifact(path, expected_backend_id="handcrafted", expected_profile="fast", device="cpu")
        assert isinstance(loaded.model, TorchMLPClassifier)
        np.testing.assert_array_equal(loaded.model.predict(X), theirs.predict(X))
    assert loaded.expected_feature_size == n_features
    sidecar = json.loads(path.with_suffix(".pkl.meta.json").read_text())
    assert sidecar == loaded.artifact_metadata
    umask = os.umask(0)
    os.umask(umask)
    assert path.stat().st_mode & 0o777 == 0o666 & ~umask
    assert not [p for p in path.parent.iterdir() if p.name.startswith(".ser_model")]


def test_saved_envelopes_hold_the_same_payload(tmp_path, fitted_pair) -> None:
    """The port's envelope unpickles to the JAX package's structure, field for field."""
    ours, *_ = fitted_pair
    metadata = _metadata(artifacts)
    envelope = artifacts.build_model_artifact(ours, metadata)
    path = artifacts.save_model_artifact(envelope, tmp_path / "a.pkl")
    with open(path, "rb") as handle:
        raw = pickle.load(handle)
    assert raw["artifact_version"] == raw["metadata"]["artifact_version"] == 3
    assert raw["model"]["kind"] == "ser_tpu_mlp" and raw["metadata"] == metadata
    jax_envelope = jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(raw["model"]), metadata)
    assert sorted(jax_envelope) == sorted(raw) and sorted(jax_envelope["model"]) == sorted(raw["model"])


# --------------------------------------------------------------------------- #
# Metrics
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_ser_tpu(seed: int) -> None:
    rng = np.random.default_rng(seed)
    classes = ["angry", "happy", "neutral", "sad", "surprised"]
    n = 60
    y_true = [classes[i] for i in rng.integers(0, 5, n)]
    y_pred = [classes[i] if rng.random() < 0.6 else "calm" for i in rng.integers(0, 5, n)]
    samples = [f"s{i}" for i in rng.integers(0, 20, n)]
    groups = [["ravdess", "crema-d"][i] for i in rng.integers(0, 2, n)]
    for labels in (None, classes):
        assert metrics.compute_ser_metrics(y_true=y_true, y_pred=y_pred, labels=labels) == \
            jax_metrics.compute_ser_metrics(y_true=y_true, y_pred=y_pred, labels=labels)
    assert metrics.accuracy(y_true, y_pred) == jax_metrics.accuracy(y_true, y_pred)
    for support in (1, 3):
        assert metrics.compute_grouped_ser_metrics_by_sample(
            y_true=y_true, y_pred=y_pred, sample_ids=samples, group_ids=groups, min_support=support
        ) == jax_metrics.compute_grouped_ser_metrics_by_sample(
            y_true=y_true, y_pred=y_pred, sample_ids=samples, group_ids=groups, min_support=support
        )
        assert metrics.compute_sample_level_ser_metrics(
            y_true=y_true, y_pred=y_pred, sample_ids=samples, min_support=support
        ) == jax_metrics.compute_sample_level_ser_metrics(
            y_true=y_true, y_pred=y_pred, sample_ids=samples, min_support=support
        )


def test_metrics_refuse_alike() -> None:
    for call in (lambda m: m.compute_ser_metrics(y_true=["a"], y_pred=[]),
                 lambda m: m.compute_ser_metrics(y_true=[], y_pred=[]),
                 lambda m: m.accuracy([], []),
                 lambda m: m.compute_sample_level_ser_metrics(y_true=["a"], y_pred=["a"], sample_ids=["s"], min_support=2),
                 lambda m: m.compute_grouped_ser_metrics_by_sample(y_true=["a"], y_pred=["a"], sample_ids=["s"],
                                                                   group_ids=["g"], min_support=0)):
        with pytest.raises(ValueError) as ours:
            call(metrics)
        with pytest.raises(ValueError) as theirs:
            call(jax_metrics)
        assert str(ours.value) == str(theirs.value)
