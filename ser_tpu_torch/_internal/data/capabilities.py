"""Dataset capability catalog + installed-dataset capability snapshot.

Counterpart of ``ser_tpu/_internal/data/capabilities.py``: the same profiles and the same ``data catalog`` payload.

Parity surface: reference ``ser/_internal/data/dataset_capabilities.py:8-313``
(the per-dataset capability profile table — every value below matches the
reference's, differential-tested) and
``data/application/capability_snapshot.py:20-177`` (manifest audio stats and
the ``ser data catalog`` snapshot/JSON payload).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig


@dataclass(frozen=True, slots=True)
class DatasetCapabilityProfile:
    """Static capability profile for one supported dataset."""

    dataset_id: str
    summary: str
    modalities: tuple[str, ...]
    label_schema: str
    has_label_mapping: bool
    supervised_ser_candidate: bool
    ssl_candidate: bool
    multimodal_candidate: bool
    mergeable_with_emotion_ontology: bool
    recommended_uses: tuple[str, ...]
    notes: tuple[str, ...]


_SUPERVISED_USES = ("supervised_ser_training", "cross_corpus_emotion_merge", "ssl_pretraining")
_CROSS_LINGUAL_USES = (
    "supervised_ser_training",
    "cross_lingual_emotion_transfer",
    "ssl_pretraining",
)


def _profile(
    dataset_id: str,
    summary: str,
    *,
    modalities: tuple[str, ...] = ("audio",),
    label_schema: str,
    has_label_mapping: bool = True,
    supervised: bool = True,
    ssl: bool = True,
    multimodal: bool = False,
    mergeable: bool = True,
    uses: tuple[str, ...],
    notes: tuple[str, ...],
) -> DatasetCapabilityProfile:
    return DatasetCapabilityProfile(
        dataset_id=dataset_id,
        summary=summary,
        modalities=modalities,
        label_schema=label_schema,
        has_label_mapping=has_label_mapping,
        supervised_ser_candidate=supervised,
        ssl_candidate=ssl,
        multimodal_candidate=multimodal,
        mergeable_with_emotion_ontology=mergeable,
        recommended_uses=uses,
        notes=notes,
    )


#: All 16 supported datasets. Values are the reference's exact capability
#: metadata (``dataset_capabilities.py``) — they drive pipeline-planning
#: output and must not drift.
_PROFILES: dict[str, DatasetCapabilityProfile] = {
    profile.dataset_id: profile
    for profile in (
        _profile(
            "ravdess",
            "North American acted emotional speech (24 actors).",
            label_schema="emotion_8_class",
            uses=_SUPERVISED_USES,
            notes=("Acted speech; no transcript channel in current pipeline.",),
        ),
        _profile(
            "crema-d",
            "Acted emotional speech with canonical emotion categories.",
            label_schema="emotion_6_class",
            uses=_SUPERVISED_USES,
            notes=("Acted speech; no transcript channel in current pipeline.",),
        ),
        _profile(
            "msp-podcast",
            "Conversational segments with challenge-style categorical emotion labels.",
            modalities=("audio", "label_csv"),
            label_schema="emotion_8_class",
            uses=_SUPERVISED_USES,
            notes=("Academic-license constraints apply.",),
        ),
        _profile(
            "biic-podcast",
            "BIIC podcast corpus with access and labeling workflow managed externally.",
            modalities=("audio", "external_labels"),
            label_schema="externally_managed",
            has_label_mapping=False,
            supervised=False,
            mergeable=False,
            uses=("ssl_pretraining", "domain_adaptation"),
            notes=("Manual access and custom label pipeline are required.",),
        ),
        _profile(
            "emodb-2.0",
            "German emotional speech corpus with provided metadata labels.",
            modalities=("audio", "metadata_csv"),
            label_schema="emotion_mapped_to_canonical",
            uses=_CROSS_LINGUAL_USES,
            notes=("Label mapping normalizes boredom into neutral.",),
        ),
        _profile(
            "escorpus-pe",
            "Peruvian Spanish speech corpus with filename-encoded VAD dimensions.",
            modalities=("audio", "dimensional_annotations"),
            label_schema="vad_heuristic_to_canonical",
            has_label_mapping=False,
            supervised=False,
            mergeable=False,
            uses=("ssl_pretraining", "domain_adaptation", "representation_learning"),
            notes=(
                "VAD triplets are converted to weak categorical proxies; "
                "not recommended as a primary supervised target.",
            ),
        ),
        _profile(
            "mesd",
            "Mexican Spanish emotional speech dataset.",
            modalities=("audio", "metadata"),
            label_schema="emotion_mapped_to_canonical",
            uses=_CROSS_LINGUAL_USES,
            notes=("Labels inferred from canonical filename prefixes.",),
        ),
        _profile(
            "oreau-french-esd",
            "French expressive speech dataset distributed as multi-part RAR.",
            label_schema="emotion_inferred_from_paths",
            uses=_CROSS_LINGUAL_USES,
            notes=("Requires external RAR extraction backend in runtime environment.",),
        ),
        _profile(
            "jl-corpus",
            "English emotional speech corpus with anxious label variant.",
            label_schema="emotion_mapped_to_canonical",
            uses=_SUPERVISED_USES,
            notes=(
                "Primary source is Kaggle; automation falls back to Hugging Face "
                "rows API when Kaggle credentials are unavailable.",
            ),
        ),
        _profile(
            "cafe",
            "Canadian French emotional speech corpus (CaFE).",
            label_schema="emotion_mapped_to_canonical",
            uses=_CROSS_LINGUAL_USES,
            notes=("Noncommercial license constraints apply.",),
        ),
        _profile(
            "asvp-esd",
            "Spanish emotional speech dataset packaged on Zenodo.",
            label_schema="emotion_inferred_from_paths",
            uses=_CROSS_LINGUAL_USES,
            notes=("Label extraction is filename/path-driven in current automation.",),
        ),
        _profile(
            "emov-db",
            "OpenSLR SLR115 emotional voice database.",
            label_schema="emotion_mapped_to_canonical",
            uses=_SUPERVISED_USES,
            notes=("Noncommercial license constraints apply.",),
        ),
        _profile(
            "pavoque",
            "PAVOQUE expressive corpus from GitHub release assets.",
            modalities=("audio", "timing_metadata"),
            label_schema="emotion_mapped_to_canonical",
            uses=_SUPERVISED_USES,
            notes=("Current pipeline uses filename-driven labels; YAML segmentation is pending.",),
        ),
        _profile(
            "att-hack",
            "French social-attitude corpus (friendly/distant/dominant/seductive).",
            modalities=("audio", "text"),
            label_schema="social_attitude_classes",
            supervised=False,
            multimodal=True,
            mergeable=False,
            uses=(
                "ssl_pretraining",
                "paralinguistic_style_modeling",
                "audio_text_representation_learning",
            ),
            notes=(
                "Labels are not canonical SER emotions; suitable for auxiliary "
                "tasks and SSL.",
            ),
        ),
        _profile(
            "coraa-ser",
            "Brazilian Portuguese challenge corpus with neutral/non-neutral labels.",
            label_schema="binary_plus_gender_non_neutral",
            supervised=False,
            mergeable=False,
            uses=("ssl_pretraining", "binary_affect_detection", "domain_adaptation"),
            notes=("Labels are challenge-specific; not canonical emotion classes.",),
        ),
        _profile(
            "spanish-meacorpus-2023",
            "Spanish multimodal emotion metadata corpus from YouTube.",
            modalities=("audio", "text", "metadata"),
            label_schema="emotion_mapped_to_canonical",
            multimodal=True,
            uses=("supervised_ser_training", "audio_text_emotion_fusion", "ssl_pretraining"),
            notes=(
                "Zenodo ships metadata/transcripts; audio needs local rehydration "
                "from YouTube.",
            ),
        ),
    )
}


def resolve_dataset_capability_profile(dataset_id: str) -> DatasetCapabilityProfile:
    """One static capability profile for a supported dataset id."""
    profile = _PROFILES.get(dataset_id)
    if profile is None:
        raise ValueError(f"No capability profile registered for dataset {dataset_id!r}.")
    return profile


def list_dataset_capability_profiles() -> tuple[DatasetCapabilityProfile, ...]:
    """All capability profiles ordered by dataset id."""
    return tuple(_PROFILES[key] for key in sorted(_PROFILES))


# --------------------------------------------------------------------------- #
# Installed-dataset capability snapshot (``ser data catalog``)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True, slots=True)
class DatasetCapabilitySnapshotEntry:
    """One installed (or supported) dataset's capability + install state."""

    dataset_id: str
    display_name: str
    registered: bool
    installed: bool
    manifest_exists: bool
    dataset_root: Path | None
    manifest_path: Path | None
    referenced_audio_files: int
    present_audio_files: int
    nonempty_audio_files: int
    dataset_size_bytes: int
    source_url: str
    policy_id: str
    license_id: str
    modalities: tuple[str, ...]
    label_schema: str
    has_label_mapping: bool
    supervised_ser_candidate: bool
    ssl_candidate: bool
    multimodal_candidate: bool
    mergeable_with_emotion_ontology: bool
    recommended_uses: tuple[str, ...]
    notes: tuple[str, ...]


def _collect_manifest_audio_stats(
    *, manifest_path: Path | None, dataset_root: Path | None
) -> tuple[int, int, int, int]:
    """(referenced, present, nonempty, total_bytes) over unique manifest rows."""
    if manifest_path is None or not manifest_path.is_file():
        return (0, 0, 0, 0)
    referenced = present = nonempty = total_bytes = 0
    seen_paths: set[Path] = set()
    with manifest_path.open("r", encoding="utf-8") as handle:
        for line in handle:
            text = line.strip()
            if not text or text.startswith("#"):
                continue
            try:
                payload = json.loads(text)
            except json.JSONDecodeError:
                continue
            if not isinstance(payload, dict):
                continue
            raw_audio_path = payload.get("audio_path")
            if not isinstance(raw_audio_path, str) or not raw_audio_path.strip():
                continue
            candidate = Path(raw_audio_path).expanduser()
            if not candidate.is_absolute():
                # Relative rows resolve against the manifest's directory (the
                # writer's base_dir), falling back to the dataset root.
                base = manifest_path.parent if manifest_path else dataset_root
                candidate = ((base or Path(".")) / candidate).expanduser()
            if candidate in seen_paths:
                continue
            seen_paths.add(candidate)
            referenced += 1
            if not candidate.is_file():
                continue
            present += 1
            size_bytes = candidate.stat().st_size
            total_bytes += size_bytes
            if size_bytes > 0:
                nonempty += 1
    return (referenced, present, nonempty, total_bytes)


def collect_dataset_capability_snapshot(
    *, settings: AppConfig, include_uninstalled: bool = False
) -> tuple[DatasetCapabilitySnapshotEntry, ...]:
    """Capability records for installed datasets (or all supported)."""
    from ser_tpu_torch._internal.data.catalog import DATASET_CATALOG
    from ser_tpu_torch._internal.data.registry import list_registered_datasets

    registry_by_id = {
        record.dataset_id: record
        for record in list_registered_datasets(settings=settings)
    }
    rows: list[DatasetCapabilitySnapshotEntry] = []
    for dataset_id in sorted(DATASET_CATALOG):
        spec = DATASET_CATALOG[dataset_id]
        record = registry_by_id.get(dataset_id)
        registered = record is not None
        manifest_path = Path(record.manifest_path) if record is not None else None
        dataset_root = Path(record.dataset_root) if record is not None else None
        manifest_exists = manifest_path.is_file() if manifest_path is not None else False
        referenced, present, nonempty, size_bytes = _collect_manifest_audio_stats(
            manifest_path=manifest_path, dataset_root=dataset_root
        )
        installed = registered and manifest_exists and nonempty > 0
        if not include_uninstalled and not installed:
            continue
        profile = resolve_dataset_capability_profile(dataset_id)
        rows.append(
            DatasetCapabilitySnapshotEntry(
                dataset_id=dataset_id,
                display_name=spec.display_name,
                registered=registered,
                installed=installed,
                manifest_exists=manifest_exists,
                dataset_root=dataset_root,
                manifest_path=manifest_path,
                referenced_audio_files=referenced,
                present_audio_files=present,
                nonempty_audio_files=nonempty,
                dataset_size_bytes=size_bytes,
                source_url=spec.source_url,
                policy_id=spec.policy_id,
                license_id=spec.license_id,
                modalities=profile.modalities,
                label_schema=profile.label_schema,
                has_label_mapping=profile.has_label_mapping,
                supervised_ser_candidate=profile.supervised_ser_candidate,
                ssl_candidate=profile.ssl_candidate,
                multimodal_candidate=profile.multimodal_candidate,
                mergeable_with_emotion_ontology=profile.mergeable_with_emotion_ontology,
                recommended_uses=profile.recommended_uses,
                notes=profile.notes,
            )
        )
    return tuple(rows)


def build_dataset_capability_snapshot_json_payload(
    rows: tuple[DatasetCapabilitySnapshotEntry, ...],
) -> dict[str, object]:
    """The reference's ``{"entries": [...]}`` JSON payload shape."""
    entries: list[dict[str, object]] = []
    for row in rows:
        entries.append(
            {
                "dataset_id": row.dataset_id,
                "display_name": row.display_name,
                "registered": row.registered,
                "installed": row.installed,
                "manifest_exists": row.manifest_exists,
                "dataset_root": (
                    str(row.dataset_root) if row.dataset_root is not None else None
                ),
                "manifest_path": (
                    str(row.manifest_path) if row.manifest_path is not None else None
                ),
                "referenced_audio_files": row.referenced_audio_files,
                "present_audio_files": row.present_audio_files,
                "nonempty_audio_files": row.nonempty_audio_files,
                "dataset_size_bytes": row.dataset_size_bytes,
                "source_url": row.source_url,
                "policy_id": row.policy_id,
                "license_id": row.license_id,
                "modalities": list(row.modalities),
                "label_schema": row.label_schema,
                "has_label_mapping": row.has_label_mapping,
                "supervised_ser_candidate": row.supervised_ser_candidate,
                "ssl_candidate": row.ssl_candidate,
                "multimodal_candidate": row.multimodal_candidate,
                "mergeable_with_emotion_ontology": row.mergeable_with_emotion_ontology,
                "recommended_uses": list(row.recommended_uses),
                "notes": list(row.notes),
            }
        )
    return {"entries": entries}


__all__ = [
    "DatasetCapabilityProfile",
    "DatasetCapabilitySnapshotEntry",
    "build_dataset_capability_snapshot_json_payload",
    "collect_dataset_capability_snapshot",
    "list_dataset_capability_profiles",
    "resolve_dataset_capability_profile",
]
