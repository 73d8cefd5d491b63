"""MLP head and artifact loading of the PyTorch port against the JAX package.

The same ``ser_tpu_mlp`` state goes into ``JaxMLPClassifier`` and
``TorchMLPClassifier``: probabilities agree to 1e-6 and labels are identical.
An envelope written by ``ser_tpu``'s artifact writer loads in the port, and
the port's restricted unpickler refuses any global but numpy's array,
dtype and scalar reconstructors (a ``ser_tpu`` class above all).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest

from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu.models.mlp_head import JaxMLPClassifier
from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

CLASSES = ["angry", "calm", "happy", "neutral", "sad"]


def _state(seed: int = 0, n_features: int = 24, hidden: tuple[int, ...] = (16,)) -> dict:
    rng = np.random.default_rng(seed)
    dims = [n_features, *hidden, len(CLASSES)]
    return {
        "kind": "ser_tpu_mlp",
        "hidden_layer_sizes": list(hidden),
        "alpha": 0.01,
        "batch_size": 256,
        "epsilon": 1e-8,
        "max_iter": 500,
        "random_state": 42,
        "classes": list(CLASSES),
        # Glorot-scale weights, the scale of a trained head.
        "weights": [
            (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])
        ],
        "biases": [(0.1 * rng.standard_normal(b)).astype(np.float32) for b in dims[1:]],
        "n_iter": 7,
        "loss": 0.5,
    }


@pytest.mark.parametrize("hidden", [(16,), (32, 8)])
def test_probabilities_and_labels_match_jax_head(hidden) -> None:
    state = _state(n_features=24, hidden=hidden)
    features = np.random.default_rng(1).standard_normal((40, 24))
    jax_head = JaxMLPClassifier.from_state(state)
    torch_head = TorchMLPClassifier.from_state(state, device="cpu")
    np.testing.assert_allclose(
        torch_head.decision_function(features), jax_head.decision_function(features), atol=1e-5
    )
    np.testing.assert_allclose(torch_head.predict_proba(features), jax_head.predict_proba(features), atol=1e-6)
    assert torch_head.predict(features).tolist() == jax_head.predict(features).tolist()
    assert torch_head.classes_.tolist() == jax_head.classes_.tolist()


def test_from_state_refuses_other_payloads() -> None:
    with pytest.raises(ValueError, match="ser_tpu_mlp"):
        TorchMLPClassifier.from_state({"kind": "sklearn"}, device="cpu")


def _write_jax_artifact(path, *, state: dict) -> None:
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=24,
        training_samples=10,
        labels=CLASSES,
        backend_id="jax_whisper_encoder",
        profile="accurate",
        pooling_strategy="mean_std",
        backend_model_id="openai/whisper-large-v3",
    )
    envelope = jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata)
    jax_artifacts.save_model_artifact(envelope, path)


def test_loads_an_artifact_written_by_ser_tpu(tmp_path) -> None:
    state = _state(3)
    path = tmp_path / "head.pkl"
    _write_jax_artifact(path, state=state)
    loaded = artifacts.load_model_artifact(
        path,
        expected_backend_id="jax_whisper_encoder",
        expected_profile="accurate",
        expected_model_id="openai/whisper-large-v3",
        device="cpu",
    )
    reference = jax_artifacts.load_model_artifact(path)
    features = np.random.default_rng(4).standard_normal((12, 24))
    assert loaded.expected_feature_size == reference.expected_feature_size == 24
    np.testing.assert_allclose(
        loaded.model.predict_proba(features), reference.model.predict_proba(features), atol=1e-6
    )


@pytest.mark.parametrize(
    "expected",
    [
        {"expected_backend_id": "jax_xlsr"},
        {"expected_profile": "medium"},
        {"expected_model_id": "openai/whisper-small"},
    ],
)
def test_compatibility_filters_refuse_a_mismatch(tmp_path, expected) -> None:
    path = tmp_path / "head.pkl"
    _write_jax_artifact(path, state=_state())
    with pytest.raises(artifacts.ArtifactError, match="mismatch"):
        artifacts.load_model_artifact(path, **expected, device="cpu")


@pytest.mark.parametrize(
    ("payload", "named"),
    [
        (JaxMLPClassifier.from_state(_state()), "ser_tpu.models.mlp_head"),
        (np.save, "save"),
        (os.getcwd, "getcwd"),
    ],
    ids=["ser_tpu_class", "numpy_function", "os_function"],
)
def test_unpickler_refuses_anything_but_numpy_reconstructors(tmp_path, payload, named) -> None:
    path = tmp_path / "object.pkl"
    envelope = {"artifact_version": 3, "model": payload, "metadata": {"artifact_version": 3}}
    path.write_bytes(pickle.dumps(envelope))
    with pytest.raises(artifacts.ArtifactError, match=named):
        artifacts.load_model_artifact(path, device="cpu")


def test_version_split_is_refused(tmp_path) -> None:
    path = tmp_path / "head.pkl"
    _write_jax_artifact(path, state=_state())
    envelope = pickle.loads(path.read_bytes())
    envelope["artifact_version"] = 2
    path.write_bytes(pickle.dumps(envelope))
    with pytest.raises(artifacts.ArtifactError, match="versions must match"):
        artifacts.load_model_artifact(path, device="cpu")


@pytest.mark.parametrize("model_id", ["openai/whisper-large-v3", "openai/whisper-small", "Org/My Model v2"])
def test_artifact_file_name_matches_ser_tpu(model_id) -> None:
    reference = profile_artifact_file_names(profile="accurate", accurate_model_id=model_id)[0]
    assert profile_artifact_file_name(profile="accurate", model_id=model_id) == reference
