"""Internal data API (reference ``ser/_internal/api/data.py`` parity).

Counterpart of ``ser_tpu/_internal/api/data.py``: the dataset half of the port's public API.
"""

from __future__ import annotations

from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data.catalog import list_dataset_ids
from ser_tpu_torch._internal.data.consents import configure_dataset_consents, show_dataset_consents
from ser_tpu_torch._internal.data.prepare import (
    ComplianceMode,
    DatasetPrepareResult,
    prepare_dataset as _prepare_dataset,
)
from ser_tpu_torch._internal.data.registry import (
    DatasetRegistryHealthIssueRecord,
    DatasetRegistryRecord,
    audit_registry_health,
    list_registered_datasets,
)
from ser_tpu_torch.domain import DatasetConsents

__all__ = [
    "ComplianceMode",
    "DatasetPrepareResult",
    "DatasetRegistryHealthIssueRecord",
    "DatasetRegistryRecord",
    "configure_dataset_consents",
    "list_dataset_registry_health_issues",
    "list_datasets",
    "list_registered_datasets",
    "prepare_dataset",
    "show_dataset_consents",
]


def list_datasets() -> tuple[str, ...]:
    """All supported dataset identifiers in deterministic order."""
    return list_dataset_ids()


def list_dataset_registry_health_issues(
    *, settings: AppConfig
) -> tuple[DatasetRegistryHealthIssueRecord, ...]:
    """Registry health issues for the active settings snapshot."""
    return audit_registry_health(settings=settings)


def prepare_dataset(
    *,
    dataset_id: str,
    dataset_root: Path | None = None,
    manifest_path: Path | None = None,
    labels_csv_path: Path | None = None,
    audio_base_dir: Path | None = None,
    source_repo_id: str | None = None,
    source_revision: str | None = None,
    default_language: str | None = None,
    skip_download: bool = False,
    accept_license: bool = False,
    compliance_mode: ComplianceMode = "advisory",
    settings: AppConfig,
) -> DatasetPrepareResult:
    """Programmatic dataset preparation."""
    return _prepare_dataset(
        dataset_id=dataset_id,
        dataset_root=dataset_root,
        manifest_path=manifest_path,
        labels_csv_path=labels_csv_path,
        audio_base_dir=audio_base_dir,
        source_repo_id=source_repo_id,
        source_revision=source_revision,
        default_language=default_language,
        skip_download=skip_download,
        accept_license=accept_license,
        compliance_mode=compliance_mode,
        settings=settings,
    )
