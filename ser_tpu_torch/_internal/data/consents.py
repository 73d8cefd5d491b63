"""Dataset policy/license consent persistence and enforcement.

Counterpart of ``ser_tpu/_internal/data/consents.py``: the same store on disk, so a consent recorded by either package holds in the other.

Parity surface: reference ``ser/_internal/data/dataset_consents.py`` —
consents persist as a schema-versioned JSON store mapping normalized
policy/license ids to the consent SOURCE, at
``<models_folder_parent>/.ser/dataset_consents.json`` (override:
``SER_DATASET_CONSENTS_FILE``), written atomically. The on-disk format is
byte-compatible with the reference's so a user switching frameworks keeps
every previously granted consent.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data.catalog import get_dataset_spec
from ser_tpu_torch.domain import DatasetConsents

_CONSENT_STORE_ENV = "SER_DATASET_CONSENTS_FILE"
_CONSENT_SCHEMA_VERSION = 1
_CONSENT_FILE_NAME = "dataset_consents.json"


class ConsentError(PermissionError):
    """Raised when a dataset is used without the required consents."""


def _store_path(settings: AppConfig | None = None) -> Path:
    explicit = os.getenv(_CONSENT_STORE_ENV, "").strip()
    if explicit:
        return Path(explicit).expanduser()
    settings = settings if settings is not None else reload_settings()
    return Path(settings.models.folder).parent / ".ser" / _CONSENT_FILE_NAME


def _load_store(path: Path) -> tuple[dict[str, str], dict[str, str]]:
    """Reads the schema-versioned store: (policy→source, license→source)."""
    if not path.is_file():
        return {}, {}
    try:
        raw = json.loads(path.read_text(encoding="utf-8"))
    except Exception as err:  # noqa: BLE001 - unreadable store must be loud
        raise RuntimeError(f"Dataset consent store at {path} is unreadable: {err}") from err
    if not isinstance(raw, dict):
        raise RuntimeError(f"Dataset consent store at {path} must be a JSON object.")
    schema_version = raw.get("schema_version")
    if schema_version is not None and schema_version != _CONSENT_SCHEMA_VERSION:
        raise RuntimeError(
            "Dataset consent store schema mismatch. "
            f"Expected {_CONSENT_SCHEMA_VERSION}, got {schema_version!r}."
        )
    policy = raw.get("policy_consents", {})
    licenses = raw.get("license_consents", {})
    policy = policy if isinstance(policy, dict) else {}
    licenses = licenses if isinstance(licenses, dict) else {}
    return (
        {str(k): str(v) for k, v in policy.items()},
        {str(k): str(v) for k, v in licenses.items()},
    )


def show_dataset_consents(*, settings: AppConfig | None = None) -> DatasetConsents:
    """Returns the persisted consent record."""
    try:
        policy, licenses = _load_store(_store_path(settings))
    except RuntimeError:
        return DatasetConsents(policy_ids=(), license_ids=())
    return DatasetConsents(
        policy_ids=tuple(sorted(policy)),
        license_ids=tuple(sorted(licenses)),
    )


def configure_dataset_consents(
    *,
    accept_policy_ids: tuple[str, ...] = (),
    accept_license_ids: tuple[str, ...] = (),
    settings: AppConfig | None = None,
    source: str = "ser_tpu_torch.api.configure_dataset_consents",
) -> DatasetConsents:
    """Merges new consents into the persisted record and returns the result.

    Ids normalize to stripped lowercase and each records the granting SOURCE
    (reference ``dataset_consents.py:96-105``); the write is atomic so a
    crashed CLI never truncates previously granted consents.
    """
    path = _store_path(settings)
    policy, licenses = _load_store(path)
    for policy_id in accept_policy_ids:
        normalized = policy_id.strip().lower()
        if normalized:
            policy[normalized] = source
    for license_id in accept_license_ids:
        normalized = license_id.strip().lower()
        if normalized:
            licenses[normalized] = source

    payload = {
        "schema_version": _CONSENT_SCHEMA_VERSION,
        "policy_consents": dict(sorted(policy.items())),
        "license_consents": dict(sorted(licenses.items())),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp_path = path.with_suffix(path.suffix + ".tmp")
    serialized = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    try:
        with tmp_path.open("w", encoding="utf-8") as handle:
            handle.write(serialized)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp_path, path)
    finally:
        if tmp_path.exists():
            tmp_path.unlink(missing_ok=True)
    return DatasetConsents(
        policy_ids=tuple(sorted(policy)),
        license_ids=tuple(sorted(licenses)),
    )


def ensure_dataset_consent(
    dataset_id: str, *, settings: AppConfig | None = None, accept_license: bool = False
) -> None:
    """Raises ``ConsentError`` unless the dataset's policy+license are consented."""
    spec = get_dataset_spec(dataset_id)
    if not spec.requires_consent:
        return
    if accept_license:
        configure_dataset_consents(
            accept_policy_ids=(spec.policy_id,),
            accept_license_ids=(spec.license_id,),
            settings=settings,
            source=f"prepare_dataset:{dataset_id}",
        )
        return
    consents = show_dataset_consents(settings=settings)
    if (
        spec.policy_id.strip().lower() not in consents.policy_ids
        or spec.license_id.strip().lower() not in consents.license_ids
    ):
        raise ConsentError(
            f"Dataset {dataset_id!r} requires consent to policy {spec.policy_id!r} and "
            f"license {spec.license_id!r}. Pass accept_license=True or run "
            "`ser data consents --accept ...`."
        )


__all__ = [
    "ConsentError",
    "configure_dataset_consents",
    "ensure_dataset_consent",
    "show_dataset_consents",
]
