"""Dataset preparation: local sources → validated manifest + registry record.

Counterpart of ``ser_tpu/_internal/data/prepare.py``: the same manifests and registry records.

Parity surface: reference ``ser/_internal/data/dataset_prepare.py`` +
``adapters/`` + ``strategies/`` — per-dataset manifest builders behind a
strategy registry, consent enforcement, and registry persistence.

Acquisition: when the dataset root is missing and ``skip_download=False``,
the per-provider workflow in :mod:`provider_prepare` runs (zenodo record
enumeration, OpenSLR mirrors, Mendeley tree, GitHub releases/LFS, Kaggle/HF
fallbacks). In a zero-egress runtime that surfaces a typed staging error;
``skip_download=True`` with pre-materialized data is always supported.
Resolution order per dataset (reference auto-CSV semantics):

1. an existing manifest: validate + register as-is;
2. an explicit labels CSV;
3. a generated ``labels.csv`` at the dataset root;
4. the corpus's filename strategy (``strategies.py`` — all 16 catalog ids).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data import consents as consents_module
from ser_tpu_torch._internal.data import registry as registry_module
from ser_tpu_torch._internal.data.catalog import get_dataset_spec
from ser_tpu_torch._internal.data.loader import (
    extract_ravdess_emotion_code,
    extract_ravdess_speaker_id_from_path,
)
from ser_tpu_torch._internal.data.manifest import (
    PRIMARY_EMOTIONS,
    Utterance,
    read_manifest_jsonl,
    write_manifest_jsonl,
)
type ComplianceMode = Literal["advisory", "enforced"]

# One exception type across the acquisition surface: a second identically
# named class here made `except downloads.DatasetDownloadUnavailableError`
# silently miss the one raised by prepare_dataset.
from ser_tpu_torch._internal.data.downloads import (  # noqa: E402
    DatasetDownloadUnavailableError,
)


@dataclass(frozen=True)
class DatasetPrepareResult:
    """Outcome of one dataset preparation run."""

    dataset_id: str
    dataset_root: str
    manifest_path: str
    utterance_count: int
    registered: bool
    warnings: tuple[str, ...] = ()


def _resolve(settings: AppConfig | None) -> AppConfig:
    return settings if settings is not None else reload_settings()


def _build_ravdess_manifest(root: Path, settings: AppConfig) -> list[Utterance]:
    emotion_map = dict(settings.emotions)
    utterances = []
    for path in sorted(root.glob("Actor_*/*.wav")):
        code = extract_ravdess_emotion_code(path.name)
        label = emotion_map.get(code or "")
        if label is None:
            continue
        utterances.append(
            Utterance(
                sample_id=path.stem,
                corpus="ravdess",
                audio_path=str(path),
                label=label,
                raw_label=code or "",
                # Corpus-scoped (reference ravdess.py:87).
                speaker_id=(
                    f"ravdess:{sp}"
                    if (sp := extract_ravdess_speaker_id_from_path(str(path)))
                    else None
                ),
                language="en",
            )
        )
    return utterances


#: Accepted CSV header aliases: ours (path/label) and the generated
#: ``labels.csv`` format the reference's download preparers emit
#: (FileName/emotion, ``public_dataset_downloads.py:213-220``).
_PATH_COLUMNS = ("path", "FileName", "file", "filename")
_LABEL_COLUMNS = ("label", "emotion")


def _build_csv_manifest(
    dataset_id: str,
    labels_csv_path: Path,
    audio_base_dir: Path | None,
    default_language: str,
    ontology=None,
) -> list[Utterance]:
    from ser_tpu_torch._internal.data.manifest import EXTENDED_LABELS
    from ser_tpu_torch._internal.data.ontology import remap_label
    from ser_tpu_torch._internal.data.strategies import _TOKEN_LABELS

    utterances = []
    with labels_csv_path.open("r", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        fields = reader.fieldnames or []
        path_col = next((c for c in _PATH_COLUMNS if c in fields), None)
        label_col = next((c for c in _LABEL_COLUMNS if c in fields), None)
        if path_col is None or label_col is None:
            raise ValueError(
                f"Labels CSV {labels_csv_path} must carry a path column "
                f"({'/'.join(_PATH_COLUMNS)}) and a label column "
                f"({'/'.join(_LABEL_COLUMNS)})."
            )
        for row_no, row in enumerate(reader, start=2):
            raw = str(row[label_col]).strip().lower()
            label = raw if raw in PRIMARY_EMOTIONS or raw in EXTENDED_LABELS else _TOKEN_LABELS.get(raw)
            if ontology is not None:
                # Unknown labels follow the ontology's disposition — dropped,
                # folded into other_label, or raised — never a bespoke CSV
                # error (reference csv_manifest_builder.py:102-105).
                label = remap_label(
                    raw_label=label if label is not None else raw,
                    mapping=None,
                    ontology=ontology,
                )
                if label is None:
                    continue
            elif label is None:
                raise ValueError(
                    f"{labels_csv_path}:{row_no}: label {raw!r} is neither canonical "
                    "nor a known synonym."
                )
            rel = Path(str(row[path_col]).strip())
            audio_path = (audio_base_dir / rel) if audio_base_dir is not None else rel
            utterances.append(
                Utterance(
                    sample_id=str(row.get("sample_id") or rel.stem),
                    corpus=dataset_id,
                    audio_path=str(audio_path),
                    label=label,
                    raw_label=str(row.get("raw_label", raw)),
                    speaker_id=(
                        f"{dataset_id}:{str(row['speaker']).strip()}"
                        if row.get("speaker") and str(row["speaker"]).strip()
                        else None
                    ),
                    language=str(row.get("language") or default_language),
                )
            )
    return utterances


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
    settings: AppConfig | None = None,
) -> DatasetPrepareResult:
    """Prepares one dataset from local materials and registers it."""
    settings = _resolve(settings)
    spec = get_dataset_spec(dataset_id)
    warnings: list[str] = []

    if compliance_mode == "enforced" or accept_license:
        consents_module.ensure_dataset_consent(
            dataset_id, settings=settings, accept_license=accept_license
        )
    elif spec.requires_consent:
        warnings.append(
            f"Dataset {dataset_id} has policy {spec.policy_id} / license {spec.license_id}; "
            "compliance_mode='advisory' does not enforce consent."
        )

    root = dataset_root if dataset_root is not None else settings.dataset.folder
    # An EMPTY existing root does not count as acquired: preparers mkdir the
    # root before their first network call, so a failed attempt would
    # otherwise permanently disable retry (root.exists() forever True).
    if not skip_download and (not root.exists() or not any(root.iterdir())):
        from ser_tpu_torch._internal.data.provider_prepare import acquire_dataset

        # Run the dataset's acquisition workflow (zenodo/openslr/mendeley/...).
        # In a zero-egress runtime every network rung fails and this raises the
        # typed staging error; connected deployments materialize the corpus.
        acquire_dataset(dataset_id, root)

    if manifest_path is not None and manifest_path.exists() and labels_csv_path is None:
        utterances = read_manifest_jsonl(manifest_path)
        final_manifest = str(manifest_path)
    else:
        from ser_tpu_torch._internal.data.strategies import GENERATED_LABELS_FILE, get_strategy

        generated_csv = root / GENERATED_LABELS_FILE
        if labels_csv_path is None and generated_csv.is_file():
            labels_csv_path = generated_csv
        if labels_csv_path is not None:
            from ser_tpu_torch._internal.data.ontology import resolve_label_ontology

            utterances = _build_csv_manifest(
                dataset_id,
                labels_csv_path,
                audio_base_dir or root,
                default_language or settings.default_language,
                ontology=resolve_label_ontology(settings),
            )
        elif dataset_id == "ravdess":
            utterances = _build_ravdess_manifest(root, settings)
        else:
            from ser_tpu_torch._internal.data.ontology import resolve_label_ontology

            utterances = get_strategy(dataset_id).build(
                root, ontology=resolve_label_ontology(settings)
            )
        if not utterances:
            raise RuntimeError(f"No labeled utterances found for {dataset_id} under {root}.")
        target = (
            manifest_path
            if manifest_path is not None
            else root / f"{dataset_id}.manifest.jsonl"
        )
        final_manifest = write_manifest_jsonl(utterances, target)

    missing = [u.audio_path for u in utterances if not Path(u.audio_path).exists()]
    if missing:
        warnings.append(f"{len(missing)} manifest audio paths are missing on disk.")

    registry_module.register_dataset(
        registry_module.DatasetRegistryRecord(
            dataset_id=dataset_id,
            dataset_root=str(root),
            manifest_path=final_manifest,
            utterance_count=len(utterances),
            revision=source_revision,
            prepared_at_unix=registry_module.now_unix(),
        ),
        settings=settings,
    )
    return DatasetPrepareResult(
        dataset_id=dataset_id,
        dataset_root=str(root),
        manifest_path=final_manifest,
        utterance_count=len(utterances),
        registered=True,
        warnings=tuple(warnings),
    )


__all__ = [
    "ComplianceMode",
    "DatasetDownloadUnavailableError",
    "DatasetPrepareResult",
    "prepare_dataset",
]
