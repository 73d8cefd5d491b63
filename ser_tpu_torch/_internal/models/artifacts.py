"""Model-artifact envelope: build, save, load, compatibility checks.

Counterpart of ``ser_tpu/_internal/models/artifacts.py``: the same v3
envelope (supported versions {2, 3}, the version in the envelope and in the
metadata, equal), the metadata ``build_artifact_metadata`` normalizes
(backend, profile, model id, device, dtype, provenance, the optional
sha256 recipe and split-ledger digests), the atomic save (a temporary file
in the target's folder, the umask's permissions, then ``replace``) with its
``<name>.meta.json`` sidecar, and the backend / profile / model-id filters
at load. An artifact written here loads in the JAX package's
``load_model_artifact``, and one written there loads here. The payload is the
``ser_tpu_mlp`` state dict; at load it becomes a ``TorchMLPClassifier`` on
the given device.

Unpickling goes through a restricted ``Unpickler`` that resolves numpy's own
array and dtype reconstructors and nothing else, so no ``ser_tpu`` (or any
other) class is imported or run. Legacy scikit-learn pickles (a bare
``MLPClassifier``, or one inside an envelope, which the JAX package loads with
``pickle.load``) load too, without scikit-learn: each ``sklearn.*`` or
``numpy.random.*`` global the pickle names becomes an inert stand-in that only
records its arguments and its ``__setstate__`` dict, and a ReLU
``MLPClassifier``'s ``coefs_``, ``intercepts_`` and ``classes_`` become a
``TorchMLPClassifier`` (a binary head's single logistic output as the second
of two softmax logits beside a zero one). Any other estimator is refused with
``ArtifactError``.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import re
import tempfile
from datetime import UTC, datetime
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.runtime.schema import ARTIFACT_SCHEMA_VERSION

logger = get_logger(__name__)

MODEL_ARTIFACT_VERSION = 3
SUPPORTED_MODEL_ARTIFACT_VERSIONS = frozenset({2, MODEL_ARTIFACT_VERSION})
DEFAULT_BACKEND_ID = "handcrafted"
DEFAULT_PROFILE_ID = "fast"
_SHA256_HEX = re.compile(r"[0-9a-f]{64}")


class ArtifactError(ValueError):
    """Raised for malformed, unsupported or incompatible model artifacts."""


class LoadedModel(NamedTuple):
    """Loaded model object and optional expected feature-vector length."""

    model: Any
    expected_feature_size: int | None
    artifact_metadata: dict[str, Any] | None = None


def build_artifact_metadata(
    *,
    feature_vector_size: int,
    training_samples: int,
    labels: list[str],
    backend_id: str = DEFAULT_BACKEND_ID,
    profile: str = DEFAULT_PROFILE_ID,
    feature_dim: int | None = None,
    frame_size_seconds: float = 3.0,
    frame_stride_seconds: float = 1.0,
    pooling_strategy: str = "mean",
    backend_model_id: str | None = None,
    model_revision: str | None = None,
    device: str | None = None,
    dtype: str | None = None,
    provenance: dict[str, Any] | None = None,
    seed: int | None = None,
    evaluation_summary: dict[str, Any] | None = None,
    recipe_digest: str | None = None,
    split_ledger_digest: str | None = None,
) -> dict[str, Any]:
    """The v3 metadata; the recipe and split-ledger digests are included only when set (sha256 hex)."""
    if feature_vector_size <= 0:
        raise ArtifactError("feature_vector_size must be positive.")
    if training_samples <= 0:
        raise ArtifactError("training_samples must be positive.")
    if not labels:
        raise ArtifactError("labels must be non-empty.")
    digests = {"recipe_digest": recipe_digest, "split_ledger_digest": split_ledger_digest}
    for name, digest in digests.items():
        if digest is not None and _SHA256_HEX.fullmatch(digest) is None:
            raise ArtifactError(f"Artifact metadata {name!r} must be sha256 hex.")
    return {
        **{name: digest for name, digest in digests.items() if digest is not None},
        "artifact_version": MODEL_ARTIFACT_VERSION,
        "artifact_schema_version": ARTIFACT_SCHEMA_VERSION,
        "created_at_utc": datetime.now(tz=UTC).isoformat(),
        "feature_vector_size": int(feature_vector_size),
        "training_samples": int(training_samples),
        "labels": [str(label) for label in labels],
        "backend_id": backend_id,
        "profile": profile,
        # An unset feature_dim is the vector size; the load requires them equal.
        "feature_dim": int(feature_dim) if feature_dim is not None else int(feature_vector_size),
        "frame_size_seconds": float(frame_size_seconds),
        "frame_stride_seconds": float(frame_stride_seconds),
        "pooling_strategy": pooling_strategy,
        "backend_model_id": backend_model_id,
        "model_revision": model_revision,
        "device": device,
        "dtype": dtype,
        "provenance": provenance or {},
        "task_heads": ["primary_emotion"],
        "seed": seed,
        # Objects, never None: a null here fails the load-time normalization.
        "sampling_policy": {},
        "evaluation_summary": evaluation_summary or {},
    }


def build_model_artifact(model: Any, metadata: dict[str, Any]) -> dict[str, Any]:
    """The envelope of a head and its metadata; the version rides at its top level and in the metadata."""
    payload = model.get_state() if isinstance(model, TorchMLPClassifier) else model
    version = dict(metadata).get("artifact_version", MODEL_ARTIFACT_VERSION)
    return {"artifact_version": version, "model": payload, "metadata": dict(metadata)}


def save_model_artifact(envelope: dict[str, Any], path: str | Path) -> str:
    """Saves one envelope atomically, and its metadata beside it as ``<name>.meta.json``."""
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(dir=target.parent, prefix=f".{target.name}.")
    try:
        with os.fdopen(fd, "wb") as handle:
            pickle.dump(envelope, handle, protocol=pickle.HIGHEST_PROTOCOL)
        # mkstemp creates 0600; a published artifact takes the umask's permissions, as the sidecar does.
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp_name, 0o666 & ~umask)
        os.replace(tmp_name, target)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise
    meta_path = target.with_suffix(target.suffix + ".meta.json")
    try:
        meta_path.write_text(json.dumps(envelope.get("metadata", {}), indent=2, default=str), encoding="utf-8")
    except OSError:
        logger.warning("Could not write metadata sidecar %s", meta_path)
    return str(target)


#: numpy's array, dtype and scalar reconstructors, the only globals a pickled
#: ``ser_tpu_mlp`` envelope references (numpy 1.x and 2.x module paths).
_NUMPY_RECONSTRUCTORS = frozenset({"_frombuffer", "_reconstruct", "dtype", "ndarray", "scalar"})
_NUMPY_MODULES = frozenset(
    {"numpy", "numpy.core.multiarray", "numpy.core.numeric", "numpy._core.multiarray", "numpy._core.numeric"}
)


class _PickledGlobal:
    """Inert stand-in for a class or function a legacy pickle names: records, runs nothing."""

    origin = ""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self.args = args

    def __setstate__(self, state: Any) -> None:
        self.state = state


#: Module prefixes whose globals become inert stand-ins (a fitted estimator and its random state).
_STAND_IN_PREFIXES = ("sklearn.", "numpy.random.")
_SKLEARN_MLP = "sklearn.neural_network._multilayer_perceptron.MLPClassifier"


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves numpy's array, dtype and scalar reconstructors; scikit-learn's globals become stand-ins."""

    def find_class(self, module: str, name: str) -> Any:
        if module in _NUMPY_MODULES and name in _NUMPY_RECONSTRUCTORS:
            return super().find_class(module, name)
        if (module, name) == ("_codecs", "encode"):  # bytes in protocol-2 pickles
            return super().find_class(module, name)
        if module.startswith(_STAND_IN_PREFIXES):
            return type(name, (_PickledGlobal,), {"origin": f"{module}.{name}"})
        raise ArtifactError(
            f"Artifact references {module}.{name}; ser_tpu_torch loads only "
            "ser_tpu_mlp envelopes of plain data and numpy arrays, and scikit-learn MLPClassifier heads."
        )


def _unpickle(data: bytes) -> Any:
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _head_from_payload(payload: Any, device: torch.device | str) -> TorchMLPClassifier:
    """The head of a ``ser_tpu_mlp`` state or of a pickled scikit-learn ``MLPClassifier``."""
    if isinstance(payload, dict) and payload.get("kind") == "ser_tpu_mlp":
        return TorchMLPClassifier.from_state(payload, device=device)
    origin = getattr(payload, "origin", None)
    state = getattr(payload, "state", None)
    if origin != _SKLEARN_MLP or not isinstance(state, dict):
        raise ArtifactError(
            f"The artifact holds {origin or type(payload).__name__}, not a ser_tpu_mlp head or a "
            "scikit-learn MLPClassifier; ser_tpu_torch loads no other estimator."
        )
    if state.get("activation") != "relu":
        raise ArtifactError(f"MLPClassifier activation {state.get('activation')!r} is not supported (relu only).")
    weights = [np.asarray(w, dtype=np.float64) for w in state["coefs_"]]
    biases = [np.asarray(b, dtype=np.float64) for b in state["intercepts_"]]
    classes = np.asarray(state["classes_"])
    out = state.get("out_activation_")
    if out == "logistic" and len(classes) == 2 and weights[-1].shape[1] == 1:
        # sigmoid(z) is the second of softmax([0, z]).
        weights[-1] = np.concatenate([np.zeros_like(weights[-1]), weights[-1]], axis=1)
        biases[-1] = np.concatenate([np.zeros_like(biases[-1]), biases[-1]])
    elif out != "softmax":
        raise ArtifactError(f"MLPClassifier output {out!r} with {len(classes)} classes is not supported.")
    return TorchMLPClassifier.from_state(
        {
            "kind": "ser_tpu_mlp",
            "hidden_layer_sizes": [w.shape[1] for w in weights[:-1]],
            "alpha": state.get("alpha", 0.0001),
            "batch_size": state.get("batch_size", "auto"),
            "epsilon": state.get("epsilon", 1e-8),
            "max_iter": state.get("max_iter", 200),
            "random_state": state.get("random_state"),
            "classes": classes.tolist(),
            "weights": weights,
            "biases": biases,
            "n_iter": state.get("n_iter_", 0),
            "loss": state.get("loss_", float("inf")),
        },
        device=device,
    )


def load_model_artifact(
    path: str | Path,
    *,
    expected_backend_id: str | None = None,
    expected_profile: str | None = None,
    expected_model_id: str | None = None,
    device: torch.device | str | None = None,
) -> LoadedModel:
    """Loads one envelope artifact, checks compatibility, and places its head on ``device``.

    ``device`` None is the device ``SER_TORCH_DEVICE`` names: the card, the
    CPU only when asked for; with neither, it raises before reading the file.
    """
    device = honor_platform_env() if device is None else torch.device(device)
    target = Path(path)
    if not target.exists():
        raise FileNotFoundError(f"Model artifact not found: {path}")
    raw = _unpickle(target.read_bytes())
    if not isinstance(raw, dict) or "model" not in raw:
        # A bare legacy estimator carries no metadata to check.
        unverifiable = [
            name
            for name, value in (
                ("backend", expected_backend_id),
                ("profile", expected_profile),
                ("model-id", expected_model_id),
            )
            if value is not None
        ]
        if unverifiable:
            logger.warning(
                "Legacy artifact %s carries no metadata; %s compatibility cannot be verified. "
                "Re-train to produce an envelope-v3 artifact.",
                target,
                "/".join(unverifiable),
            )
        return LoadedModel(model=_head_from_payload(raw, device), expected_feature_size=None)

    metadata = raw.get("metadata") or {}
    version = metadata.get("artifact_version")
    if version not in SUPPORTED_MODEL_ARTIFACT_VERSIONS:
        raise ArtifactError(
            f"Unsupported artifact version {version!r}; "
            f"supported: {sorted(SUPPORTED_MODEL_ARTIFACT_VERSIONS)}."
        )
    envelope_version = raw.get("artifact_version", version)
    if envelope_version != version:
        raise ArtifactError(
            "Model artifact envelope and metadata versions must match "
            f"(envelope {envelope_version!r} vs metadata {version!r})."
        )
    for expected, key, default, what in (
        (expected_backend_id, "backend_id", DEFAULT_BACKEND_ID, "backend"),
        (expected_profile, "profile", DEFAULT_PROFILE_ID, "profile"),
    ):
        found = metadata.get(key, default)
        if expected is not None and found != expected:
            raise ArtifactError(f"Artifact {what} mismatch: expected {expected!r}, found {found!r}.")
    if expected_model_id is not None:
        found = metadata.get("backend_model_id")
        if found is not None and found != expected_model_id:
            raise ArtifactError(
                f"Artifact model-id mismatch: expected {expected_model_id!r}, found {found!r}."
            )
    for digest_field in ("recipe_digest", "split_ledger_digest"):
        digest = metadata.get(digest_field)
        if digest is not None and (not isinstance(digest, str) or _SHA256_HEX.fullmatch(digest) is None):
            raise ArtifactError(f"Artifact metadata contains invalid {digest_field!r} value.")

    size = metadata.get("feature_vector_size")
    expected_size = int(size) if isinstance(size, int) and size > 0 else None
    feature_dim = metadata.get("feature_dim")
    if expected_size is not None and isinstance(feature_dim, int) and feature_dim != expected_size:
        raise ArtifactError(
            "Artifact metadata 'feature_dim' must match 'feature_vector_size' "
            f"({feature_dim} vs {expected_size})."
        )

    return LoadedModel(
        model=_head_from_payload(raw["model"], device),
        expected_feature_size=expected_size,
        artifact_metadata=metadata,
    )


def discover_artifact_candidates(folder: str | Path, stem_prefix: str = "ser_model") -> list[Path]:
    """The ``<stem_prefix>*.pkl`` artifacts of a models folder, newest first."""
    root = Path(folder)
    if not root.is_dir():
        return []
    return sorted(root.glob(f"{stem_prefix}*.pkl"), key=lambda p: p.stat().st_mtime, reverse=True)


__all__ = [
    "ArtifactError",
    "DEFAULT_BACKEND_ID",
    "DEFAULT_PROFILE_ID",
    "LoadedModel",
    "MODEL_ARTIFACT_VERSION",
    "SUPPORTED_MODEL_ARTIFACT_VERSIONS",
    "build_artifact_metadata",
    "build_model_artifact",
    "discover_artifact_candidates",
    "load_model_artifact",
    "save_model_artifact",
]
