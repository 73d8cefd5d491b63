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
other) class is imported or run. Legacy sklearn pickles wait for a later slice.
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

import torch

from ser_tpu_torch._internal.utils.logger import get_logger
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


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Resolves numpy's array, dtype and scalar reconstructors and nothing else."""

    def find_class(self, module: str, name: str) -> Any:
        if module in _NUMPY_MODULES and name in _NUMPY_RECONSTRUCTORS:
            return super().find_class(module, name)
        raise ArtifactError(
            f"Artifact references {module}.{name}; ser_tpu_torch loads only "
            "ser_tpu_mlp envelopes of plain data and numpy arrays."
        )


def _unpickle(data: bytes) -> Any:
    return _NumpyOnlyUnpickler(io.BytesIO(data)).load()


def load_model_artifact(
    path: str | Path,
    *,
    expected_backend_id: str | None = None,
    expected_profile: str | None = None,
    expected_model_id: str | None = None,
    device: torch.device | str = "cpu",
) -> LoadedModel:
    """Loads one envelope artifact, checks compatibility, and places its head."""
    target = Path(path)
    if not target.exists():
        raise FileNotFoundError(f"Model artifact not found: {path}")
    raw = _unpickle(target.read_bytes())
    if not isinstance(raw, dict) or "model" not in raw:
        raise ArtifactError(
            f"{target} is not a v2/v3 artifact envelope; legacy pickles are not "
            "supported by ser_tpu_torch yet (see ROADMAP.md)."
        )

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

    payload = raw["model"]
    if not (isinstance(payload, dict) and payload.get("kind") == "ser_tpu_mlp"):
        raise ArtifactError(
            f"{target} holds no ser_tpu_mlp head; other payloads (sklearn estimators) "
            "are not supported by ser_tpu_torch yet (see ROADMAP.md)."
        )
    return LoadedModel(
        model=TorchMLPClassifier.from_state(payload, device=device),
        expected_feature_size=expected_size,
        artifact_metadata=metadata,
    )


__all__ = [
    "ArtifactError",
    "DEFAULT_BACKEND_ID",
    "DEFAULT_PROFILE_ID",
    "LoadedModel",
    "MODEL_ARTIFACT_VERSION",
    "SUPPORTED_MODEL_ARTIFACT_VERSIONS",
    "build_artifact_metadata",
    "build_model_artifact",
    "load_model_artifact",
    "save_model_artifact",
]
