"""Restricted-backend license policy and consent gating.

Counterpart of ``ser_tpu/_internal/runtime/restricted_backends.py``: the
emotion2vec backend runs only with ``SER_ENABLE_RESTRICTED_BACKENDS`` on AND
either its id in ``SER_ALLOWED_RESTRICTED_BACKENDS`` or a persisted consent
record; a record carries the policy's fingerprint, so a changed policy asks
again. The policy text, its fingerprint and the consent store's path and
JSON are the JAX package's byte for byte, so consent recorded by either
package is honoured by the other. ``build_provenance_metadata`` gives the
training artifacts and reports the license and access facts at training
time, with the JAX package's keys; its dependency fingerprint covers the
port's compute-critical packages (torch, numpy).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from hashlib import sha256
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig, default_data_root
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)


class RestrictedBackendError(PermissionError):
    """Raised when a restricted backend is used without recorded consent."""


@dataclass(frozen=True)
class BackendPolicy:
    """License/usage policy for one restricted backend."""

    backend_id: str
    policy_id: str
    license_id: str
    notice: str

    @property
    def fingerprint(self) -> str:
        payload = f"{self.backend_id}|{self.policy_id}|{self.license_id}|{self.notice}"
        return sha256(payload.encode("utf-8")).hexdigest()[:16]


RESTRICTED_BACKEND_POLICIES: dict[str, BackendPolicy] = {
    "emotion2vec": BackendPolicy(
        backend_id="emotion2vec",
        policy_id="emotion2vec-research-v1",
        license_id="model-specific-research-license",
        notice=(
            "The emotion2vec model family is distributed under a research-oriented "
            "license. Confirm your use complies with the upstream model license "
            "before enabling this backend."
        ),
    ),
}


def consent_store_path() -> Path:
    """``SER_RESTRICTED_BACKENDS_CONSENT_FILE``, else ``<data root>/consents/restricted_backends.json``."""
    explicit = os.environ.get("SER_RESTRICTED_BACKENDS_CONSENT_FILE", "").strip()
    if explicit:
        return Path(explicit).expanduser()
    return default_data_root() / "consents" / "restricted_backends.json"


def _read_consents() -> dict[str, str]:
    path = consent_store_path()
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        logger.warning("Unreadable restricted-backend consent store at %s", path)
        return {}
    return {str(k): str(v) for k, v in data.items()} if isinstance(data, dict) else {}


def record_backend_consent(backend_id: str) -> None:
    """Persists consent (policy-fingerprinted) for one restricted backend."""
    policy = RESTRICTED_BACKEND_POLICIES.get(backend_id)
    if policy is None:
        raise ValueError(f"Backend {backend_id!r} has no restricted policy to consent to.")
    consents = _read_consents()
    consents[backend_id] = policy.fingerprint
    path = consent_store_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(consents, indent=2), encoding="utf-8")


def persist_all_restricted_backend_consents() -> int:
    """Persists consent for every known restricted backend; returns the count."""
    for backend_id in RESTRICTED_BACKEND_POLICIES:
        record_backend_consent(backend_id)
    return len(RESTRICTED_BACKEND_POLICIES)


def has_backend_consent(backend_id: str, *, allowed_env: tuple[str, ...] = ()) -> bool:
    """True when consent exists via the env allowlist or a fingerprint-matched record."""
    policy = RESTRICTED_BACKEND_POLICIES.get(backend_id)
    if policy is None:
        return True
    if backend_id in allowed_env:
        return True
    return _read_consents().get(backend_id) == policy.fingerprint


def ensure_backend_access(
    backend_id: str,
    *,
    settings: AppConfig,
    allowed_env: tuple[str, ...] = (),
) -> None:
    """Raises ``RestrictedBackendError`` when access is not granted."""
    policy = RESTRICTED_BACKEND_POLICIES.get(backend_id)
    if policy is None:
        return
    if not settings.runtime_flags.restricted_backends:
        raise RestrictedBackendError(
            f"Backend {backend_id!r} is restricted. Enable it with "
            "SER_ENABLE_RESTRICTED_BACKENDS=1 after reviewing its license."
        )
    effective_allowed = allowed_env or settings.runtime_flags.allowed_restricted_backends
    if not has_backend_consent(backend_id, allowed_env=effective_allowed):
        raise RestrictedBackendError(
            f"Backend {backend_id!r} requires recorded consent. Record it with "
            "record_backend_consent, or set SER_ALLOWED_RESTRICTED_BACKENDS."
        )


def build_provenance_metadata(*, settings: AppConfig, backend_id: str, profile: str) -> dict[str, object]:
    """License and access provenance for a training artifact and its report.

    The code revision (``SER_CODE_REVISION``), a fingerprint of the
    compute-critical dependency versions, and the backend's restricted-access
    facts at training time: under which policy and consent it was trained.
    """
    policy = RESTRICTED_BACKEND_POLICIES.get(backend_id)
    allowed_env = settings.runtime_flags.allowed_restricted_backends
    if policy is None:
        access_source = "unrestricted"
        access_allowed = True
    elif backend_id in allowed_env:
        access_source = "env_allowlist"
        access_allowed = settings.runtime_flags.restricted_backends
    elif _read_consents().get(backend_id) == policy.fingerprint:
        access_source = "persisted_consent"
        access_allowed = settings.runtime_flags.restricted_backends
    else:
        access_source = "denied"
        access_allowed = False
    provenance: dict[str, object] = {
        "code_revision": os.environ.get("SER_CODE_REVISION", "").strip() or "unknown",
        "dependency_manifest_fingerprint": _dependency_manifest_fingerprint(),
        "backend_id": backend_id,
        "profile": profile,
        "runtime_restricted_backends_enabled": settings.runtime_flags.restricted_backends,
        "backend_is_restricted": policy is not None,
        "backend_access_allowed": access_allowed,
        "backend_access_source": access_source,
    }
    if policy is not None:
        provenance["backend_license_id"] = policy.license_id
        provenance["restricted_backend_policy_fingerprint"] = policy.fingerprint
    return provenance


def _dependency_manifest_fingerprint() -> str:
    """Stable fingerprint of the compute-critical dependency versions."""
    import numpy
    import torch

    parts = [f"torch=={torch.__version__}", f"numpy=={numpy.__version__}"]
    return sha256("|".join(parts).encode("utf-8")).hexdigest()[:16]


__all__ = [
    "BackendPolicy",
    "RESTRICTED_BACKEND_POLICIES",
    "RestrictedBackendError",
    "build_provenance_metadata",
    "consent_store_path",
    "ensure_backend_access",
    "has_backend_consent",
    "persist_all_restricted_backend_consents",
    "record_backend_consent",
]
