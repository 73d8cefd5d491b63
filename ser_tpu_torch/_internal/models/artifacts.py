"""Model-artifact envelope, load side.

Counterpart of the load half of ``ser_tpu/_internal/models/artifacts.py``: the
same v3 envelope (supported versions {2, 3}, envelope and metadata versions
equal) and the same backend / profile / model-id compatibility filters, so an
artifact written by ``ser_tpu`` loads here unchanged. The payload must be the
``ser_tpu_mlp`` state dict; it becomes a ``TorchMLPClassifier`` on the given
device.

Unpickling goes through a restricted ``Unpickler`` that resolves numpy's own
array and dtype reconstructors and nothing else, so no ``ser_tpu`` (or any
other) class is imported or run. Legacy sklearn pickles wait for a later slice.
"""

from __future__ import annotations

import io
import pickle
import re
from pathlib import Path
from typing import Any, NamedTuple

import torch

from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

SUPPORTED_MODEL_ARTIFACT_VERSIONS = frozenset({2, 3})
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
    "LoadedModel",
    "SUPPORTED_MODEL_ARTIFACT_VERSIONS",
    "load_model_artifact",
]
