"""Restricted-backend license policy and consent gating.

Counterpart of ``ser_tpu/_internal/runtime/restricted_backends.py``: the
emotion2vec backend runs only with ``SER_ENABLE_RESTRICTED_BACKENDS`` on AND
either its id in ``SER_ALLOWED_RESTRICTED_BACKENDS`` or a persisted consent
record; a record carries the policy's fingerprint, so a changed policy asks
again. The policy text, its fingerprint and the consent store's path and
JSON are the JAX package's byte for byte, so consent recorded by either
package is honoured by the other. ``build_provenance_metadata`` serves
training artifacts, which the port does not write yet (``ROADMAP.md``).
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


__all__ = [
    "BackendPolicy",
    "RESTRICTED_BACKEND_POLICIES",
    "RestrictedBackendError",
    "consent_store_path",
    "ensure_backend_access",
    "has_backend_consent",
    "persist_all_restricted_backend_consents",
    "record_backend_consent",
]
