"""The persisted dataset registry and its health audit.

Counterpart of ``ser_tpu/_internal/data/registry.py``. Both packages read and
write the same JSON file (``datasets.json`` under
``SER_DATASET_REGISTRY_ROOT``, else ``.ser/dataset_registry.json`` beside
the models folder), under an advisory ``fcntl`` lock, with an atomic
rename. The audit reports missing roots and manifests, count mismatches,
unreadable manifests and media that are unmaterialized Git LFS pointers.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig, default_data_root
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class DatasetRegistryRecord:
    """One registered prepared dataset.

    ``options`` is the reference's free-form per-dataset option map
    (labels_csv_path, audio_base_dir, source_repo_id, ... —
    ``dataset_registry.py:31-59``), persisted verbatim; utterance_count/
    revision/prepared_at are this framework's provenance extras the
    reference's loader ignores.
    """

    dataset_id: str
    dataset_root: str
    manifest_path: str
    utterance_count: int
    revision: str | None = None
    prepared_at_unix: float = 0.0
    options: dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class DatasetRegistryHealthIssueRecord:
    """One registry health problem."""

    dataset_id: str
    issue_kind: str
    message: str


def _registry_path(settings: AppConfig | None = None) -> Path:
    # Settings-redirected registries keep test fixtures and alternate data
    # roots isolated from the user's global registry; previously the
    # parameter was accepted and ignored.
    if settings is not None and settings.dataset.registry_root is not None:
        return Path(settings.dataset.registry_root) / "datasets.json"
    # Reference location (``dataset_registry.py:125-127``): a user switching
    # frameworks keeps every registered dataset.
    if settings is None:
        from ser_tpu_torch._internal.config.bootstrap import reload_settings

        settings = reload_settings()
    return Path(settings.models.folder).parent / ".ser" / "dataset_registry.json"


@contextmanager
def _registry_lock(path: Path):
    """Advisory file lock serializing read-modify-write registry updates —
    concurrent `ser data prepare` runs must not drop each other's records."""
    lock_path = path.with_suffix(".lock")
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _read_raw(settings: AppConfig | None = None) -> dict[str, dict]:
    path = _registry_path(settings)
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
        return data if isinstance(data, dict) else {}
    except (OSError, json.JSONDecodeError):
        logger.warning("Unreadable dataset registry at %s", path)
        return {}


def list_registered_datasets(
    *, settings: AppConfig | None = None
) -> tuple[DatasetRegistryRecord, ...]:
    """All registered datasets in deterministic order."""
    raw = _read_raw(settings)
    records = []
    for dataset_id in sorted(raw):
        entry = raw[dataset_id]
        if not isinstance(entry, dict):
            # A corrupt entry must surface through the health audit, not
            # crash the listing the audit depends on.
            logger.warning("Malformed registry entry for %s; skipping.", dataset_id)
            continue
        try:
            count = int(entry.get("utterance_count", 0))
        except (TypeError, ValueError):
            count = -1
        try:
            prepared_at = float(entry.get("prepared_at_unix", 0.0))
        except (TypeError, ValueError):
            prepared_at = 0.0
        options = entry.get("options", {})
        records.append(
            DatasetRegistryRecord(
                dataset_id=dataset_id,
                dataset_root=str(entry.get("dataset_root", "")),
                manifest_path=str(entry.get("manifest_path", "")),
                utterance_count=count,
                revision=entry.get("revision"),
                prepared_at_unix=prepared_at,
                options=(
                    {str(k): str(v) for k, v in options.items()}
                    if isinstance(options, dict)
                    else {}
                ),
            )
        )
    return tuple(records)


def register_dataset(record: DatasetRegistryRecord, *, settings: AppConfig | None = None) -> None:
    """Upserts one dataset record (locked read-modify-write, atomic rename)."""
    path = _registry_path(settings)
    with _registry_lock(path):
        raw = _read_raw(settings)
        entry = asdict(record)
        entry.pop("dataset_id")
        raw[record.dataset_id] = entry
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(raw, indent=2, sort_keys=True) + "\n", encoding="utf-8")
        tmp.replace(path)


def unregister_dataset(
    dataset_id: str, *, settings: AppConfig | None = None
) -> DatasetRegistryRecord | None:
    """Removes one dataset record; returns it (or None when absent).

    Parity surface: reference ``ser data uninstall``
    (``data/application/uninstall.py``) — the registry entry goes away under
    the same lock discipline as registration; file removal is the caller's
    decision (``--keep-files``).
    """
    path = _registry_path(settings)
    with _registry_lock(path):
        raw = _read_raw(settings)
        entry = raw.pop(dataset_id, None)
        if entry is None:
            return None
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(raw, indent=2, sort_keys=True) + "\n", encoding="utf-8")
        tmp.replace(path)
        known = {
            k: v
            for k, v in entry.items()
            if k in DatasetRegistryRecord.__dataclass_fields__
        }
        return DatasetRegistryRecord(dataset_id=dataset_id, **known)


def audit_registry_health(
    *, settings: AppConfig | None = None
) -> tuple[DatasetRegistryHealthIssueRecord, ...]:
    """Checks registered datasets for missing roots/manifests and bad counts."""
    issues: list[DatasetRegistryHealthIssueRecord] = []
    for record in list_registered_datasets(settings=settings):
        if not Path(record.dataset_root).exists():
            issues.append(
                DatasetRegistryHealthIssueRecord(
                    dataset_id=record.dataset_id,
                    issue_kind="missing_root",
                    message=f"Dataset root missing: {record.dataset_root}",
                )
            )
        manifest = Path(record.manifest_path)
        if not manifest.exists():
            issues.append(
                DatasetRegistryHealthIssueRecord(
                    dataset_id=record.dataset_id,
                    issue_kind="missing_manifest",
                    message=f"Manifest missing: {record.manifest_path}",
                )
            )
            continue
        try:
            from ser_tpu_torch._internal.data.manifest import read_manifest_jsonl

            utterances = read_manifest_jsonl(manifest)
            if len(utterances) != record.utterance_count:
                issues.append(
                    DatasetRegistryHealthIssueRecord(
                        dataset_id=record.dataset_id,
                        issue_kind="count_mismatch",
                        message=(
                            f"Manifest has {len(utterances)} utterances, registry "
                            f"records {record.utterance_count}."
                        ),
                    )
                )
        except Exception as err:  # noqa: BLE001 - any manifest defect is an issue
            issues.append(
                DatasetRegistryHealthIssueRecord(
                    dataset_id=record.dataset_id,
                    issue_kind="unreadable_manifest",
                    message=f"Manifest unreadable: {err}",
                )
            )
            continue
        issues.extend(_lfs_pointer_issues(record, utterances))
    return tuple(issues)


#: How many media files per dataset the health audit sniffs for Git-LFS
#: pointers. Pointers are an all-or-nothing checkout property, so a small
#: prefix sample catches them without decoding the corpus.
_LFS_SNIFF_LIMIT = 16


def _lfs_pointer_issues(
    record: DatasetRegistryRecord, utterances
) -> list[DatasetRegistryHealthIssueRecord]:
    """Flags datasets whose media are unmaterialized Git-LFS pointers.

    The reference surfaces this in the CREMA-D adapter and repairs it with
    ``git lfs checkout``/``pull`` (``training_readiness.py:2004-2033``); the
    audit owns detection so both doctor and ``--repair`` see the same issue.
    """
    from ser_tpu_torch._internal.utils.audio_io import is_git_lfs_pointer

    for utterance in utterances[:_LFS_SNIFF_LIMIT]:
        path = Path(utterance.audio_path)
        try:
            if path.is_file() and is_git_lfs_pointer(path):
                return [
                    DatasetRegistryHealthIssueRecord(
                        dataset_id=record.dataset_id,
                        issue_kind="lfs_pointer",
                        message=(
                            f"Media are unmaterialized Git LFS pointers under "
                            f"{record.dataset_root} (e.g. {path.name}); run "
                            "`git lfs pull` or `ser --repair`."
                        ),
                    )
                ]
        except OSError:
            continue
    return []


def now_unix() -> float:
    return time.time()


__all__ = [
    "DatasetRegistryHealthIssueRecord",
    "DatasetRegistryRecord",
    "audit_registry_health",
    "list_registered_datasets",
    "now_unix",
    "register_dataset",
    "unregister_dataset",
]
