"""Utterance manifests (schema v1 and v2) and their JSONL files.

Counterpart of ``ser_tpu/_internal/data/manifest.py``: ``VadTarget``,
``TargetAnnotation``, ``Utterance`` with its validation and its
``from_record`` / ``to_record``, and the JSONL reader and writer (no header,
``#`` comments skipped, duplicate ``sample_id`` refused, one sorted-key
object a line, optional fields left out, audio paths relative to the
manifest's folder). Either package reads the files the other writes, and
``normalized_pcm_sha256`` gives the same digest of the same PCM.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from hashlib import sha256
from pathlib import Path

import numpy as np

from ser_tpu_torch._internal.data.ontology import (
    LabelOntology,
    ensure_label_allowed,
    normalize_label,
)

#: The 8-class primary emotion ontology (RAVDESS-complete superset).
PRIMARY_EMOTIONS: tuple[str, ...] = (
    "neutral",
    "calm",
    "happy",
    "sad",
    "angry",
    "fearful",
    "disgust",
    "surprised",
)

#: Corpus-native labels outside the primary ontology that manifests may
#: carry (att-hack attitudes, CORAA-SER's binary scheme); training recipes
#: filter to PRIMARY_EMOTIONS.
EXTENDED_LABELS: tuple[str, ...] = (
    "contempt",
    "friendly",
    "distant",
    "dominant",
    "seductive",
    "non_neutral_female",
    "non_neutral_male",
)

MANIFEST_SCHEMA_VERSION = 2
SUPPORTED_MANIFEST_SCHEMA_VERSIONS = frozenset({1, MANIFEST_SCHEMA_VERSION})

_SHA256_PATTERN = re.compile(r"[0-9a-f]{64}")

_SPLIT_NAMES = ("train", "dev", "test")

_ANNOTATION_TARGETS = frozenset(
    {"emotion", "vad", "social_attitude", "binary_affect", "language", "text"}
)


class ManifestError(ValueError):
    """Raised on malformed manifests or invalid utterance records."""


def default_manifest_ontology() -> LabelOntology:
    """Permissive IO-boundary ontology: primary ∪ extended labels.

    Training recipes re-validate against the active (settings-derived)
    ontology; manifest IO only rejects labels outside every known scheme.
    """
    return LabelOntology(
        ontology_id="manifest_io_v1",
        allowed_labels=frozenset(
            normalize_label(label) for label in (*PRIMARY_EMOTIONS, *EXTENDED_LABELS)
        ),
        unknown_label_policy="drop",
    )


def _read_text_field(record: dict, field: str) -> str | None:
    value = record.get(field)
    if isinstance(value, str) and value.strip():
        return value
    return None


def _read_float_field(record: dict, field: str) -> float | None:
    value = record.get(field)
    if isinstance(value, int | float) and not isinstance(value, bool):
        return float(value)
    return None


def _read_optional_float_field(record: dict, field: str) -> float | None:
    if field in record and record.get(field) is not None:
        value = _read_float_field(record, field)
        if value is None:
            raise ManifestError(f"Manifest {field!r} must be numeric when provided.")
        return value
    return None


def _maybe_relative(path: str, base_dir: Path) -> str:
    try:
        return str(Path(path).relative_to(base_dir))
    except ValueError:
        return str(path)


def _resolve_audio_path(path_text: str, base_dir: Path) -> str:
    candidate = Path(path_text)
    if candidate.is_absolute():
        return str(candidate)
    return str(base_dir / candidate)


@dataclass(frozen=True)
class VadTarget:
    """Normalized valence, arousal, and dominance target in ``[-1, 1]``."""

    valence: float
    arousal: float
    dominance: float

    def validate(self) -> None:
        for name, value in (
            ("valence", self.valence),
            ("arousal", self.arousal),
            ("dominance", self.dominance),
        ):
            if not math.isfinite(value) or not -1.0 <= value <= 1.0:
                raise ManifestError(f"VAD {name} must be finite and within [-1, 1].")

    @staticmethod
    def from_record(raw: object) -> VadTarget | None:
        if raw is None:
            return None
        if not isinstance(raw, dict):
            raise ManifestError("Manifest 'vad' target must be an object.")
        values: list[float] = []
        for field in ("valence", "arousal", "dominance"):
            value = raw.get(field)
            if not isinstance(value, int | float) or isinstance(value, bool):
                raise ManifestError(f"Manifest 'vad.{field}' must be numeric.")
            values.append(float(value))
        target = VadTarget(*values)
        target.validate()
        return target

    def to_record(self) -> dict[str, float]:
        return {
            "valence": self.valence,
            "arousal": self.arousal,
            "dominance": self.dominance,
        }


@dataclass(frozen=True)
class TargetAnnotation:
    """Source and confidence metadata for one available training target."""

    target: str
    source: str
    confidence: float | None = None

    def validate(self) -> None:
        if self.target not in _ANNOTATION_TARGETS:
            raise ManifestError(f"Unsupported annotation target {self.target!r}.")
        if not self.source.strip():
            raise ManifestError("Annotation source must be non-empty.")
        if self.confidence is not None and (
            not math.isfinite(self.confidence) or not 0.0 <= self.confidence <= 1.0
        ):
            raise ManifestError("Annotation confidence must be finite and within [0, 1].")

    @staticmethod
    def from_record(raw: object) -> TargetAnnotation:
        if not isinstance(raw, dict):
            raise ManifestError("Manifest annotations must contain objects.")
        target = _read_text_field(raw, "target")
        source = _read_text_field(raw, "source")
        confidence = _read_float_field(raw, "confidence")
        if "confidence" in raw and raw.get("confidence") is not None and confidence is None:
            raise ManifestError("Manifest annotation confidence must be numeric when provided.")
        if target is None or source is None:
            raise ManifestError("Manifest annotations require target and source fields.")
        annotation = TargetAnnotation(target, source, confidence)
        annotation.validate()
        return annotation

    def to_record(self) -> dict[str, object]:
        record: dict[str, object] = {"target": self.target, "source": self.source}
        if self.confidence is not None:
            record["confidence"] = self.confidence
        return record


@dataclass(frozen=True)
class Utterance:
    """One audio segment and any targets available for training."""

    sample_id: str
    corpus: str
    audio_path: str
    label: str | None = None
    raw_label: str | None = None
    vad: VadTarget | None = None
    social_attitude: str | None = None
    binary_affect: str | None = None
    transcript: str | None = None
    annotations: tuple[TargetAnnotation, ...] = ()
    speaker_id: str | None = None
    session_id: str | None = None
    language: str | None = None
    split: str | None = None
    native_split: str | None = None
    start_seconds: float | None = None
    duration_seconds: float | None = None
    normalized_audio_sha256: str | None = None
    dataset_revision: str | None = None
    dataset_policy_id: str | None = None
    dataset_license_id: str | None = None
    source_url: str | None = None
    schema_version: int = MANIFEST_SCHEMA_VERSION

    # ---- convenience accessors (internal callers; not wire format) ------- #

    @property
    def valence(self) -> float | None:
        return self.vad.valence if self.vad is not None else None

    @property
    def arousal(self) -> float | None:
        return self.vad.arousal if self.vad is not None else None

    @property
    def dominance(self) -> float | None:
        return self.vad.dominance if self.vad is not None else None

    @property
    def audio_sha256(self) -> str | None:
        return self.normalized_audio_sha256

    @property
    def revision(self) -> str | None:
        return self.dataset_revision

    def require_label(self) -> str:
        """The primary label, or raises at a supervised-only boundary."""
        if self.label is None:
            raise ValueError(f"Utterance {self.sample_id!r} has no primary emotion target.")
        return self.label

    def validate(self, *, ontology: LabelOntology | None = None) -> None:
        """Reference field/target validation (``manifest.py:189-249``)."""
        active = ontology if ontology is not None else default_manifest_ontology()
        if self.schema_version not in SUPPORTED_MANIFEST_SCHEMA_VERSIONS:
            raise ManifestError(
                f"Unsupported manifest schema version {self.schema_version!r}; "
                f"supported versions are {sorted(SUPPORTED_MANIFEST_SCHEMA_VERSIONS)}."
            )
        if not self.sample_id.strip():
            raise ManifestError("Utterance.sample_id must be non-empty.")
        if not self.corpus.strip():
            raise ManifestError("Utterance.corpus must be non-empty.")
        if not str(self.audio_path).strip():
            raise ManifestError("Utterance.audio_path must be a non-empty path.")
        if self.label is not None:
            try:
                ensure_label_allowed(label=self.label, ontology=active)
            except ValueError as err:
                raise ManifestError(str(err)) from err
        if self.schema_version == 1 and self.label is None:
            raise ManifestError("Manifest schema v1 requires a categorical label.")
        if self.schema_version == MANIFEST_SCHEMA_VERSION and not any(
            (
                self.label,
                self.vad,
                self.social_attitude,
                self.binary_affect,
                self.language,
                self.transcript,
            )
        ):
            raise ManifestError("Manifest schema v2 requires at least one training target.")
        expected_prefix = f"{self.corpus}:"
        for field_name, identity in (
            ("speaker_id", self.speaker_id),
            ("session_id", self.session_id),
        ):
            if identity is not None and not identity.startswith(expected_prefix):
                raise ManifestError(
                    f"{field_name} must be corpus-scoped to avoid collisions: "
                    f"expected prefix {expected_prefix!r} in {identity!r}."
                )
        for field_name, value in (("split", self.split), ("native_split", self.native_split)):
            # Runtime equivalent of the reference's ``SplitName`` Literal —
            # invalid splits are unrepresentable there by type.
            if value is not None and value not in _SPLIT_NAMES:
                raise ManifestError(
                    f"Utterance {self.sample_id}: {field_name} must be one of "
                    f"{_SPLIT_NAMES}, got {value!r}."
                )
        if self.start_seconds is not None and (
            not math.isfinite(self.start_seconds) or self.start_seconds < 0.0
        ):
            raise ManifestError("start_seconds must be finite and non-negative.")
        if self.duration_seconds is not None and (
            not math.isfinite(self.duration_seconds) or self.duration_seconds <= 0.0
        ):
            raise ManifestError("duration_seconds must be finite and positive when provided.")
        if self.normalized_audio_sha256 is not None and not _SHA256_PATTERN.fullmatch(
            self.normalized_audio_sha256
        ):
            raise ManifestError(
                "normalized_audio_sha256 must be 64 lowercase hexadecimal characters."
            )
        if self.dataset_revision is not None and not self.dataset_revision.strip():
            raise ManifestError("dataset_revision must be non-empty when provided.")
        if self.vad is not None:
            self.vad.validate()
        seen_targets: set[str] = set()
        for annotation in self.annotations:
            annotation.validate()
            if annotation.target in seen_targets:
                raise ManifestError(
                    f"Duplicate annotation metadata for {annotation.target!r}."
                )
            seen_targets.add(annotation.target)

    @staticmethod
    def from_record(
        record: dict,
        *,
        base_dir: Path,
        ontology: LabelOntology | None = None,
    ) -> Utterance:
        """Builds one utterance from a v1 or v2 parsed manifest record."""
        schema_version_raw = record.get("schema_version", 1)
        if not isinstance(schema_version_raw, int) or isinstance(schema_version_raw, bool):
            raise ManifestError("Manifest schema_version must be an integer.")
        if schema_version_raw not in SUPPORTED_MANIFEST_SCHEMA_VERSIONS:
            raise ManifestError(
                f"Unsupported manifest schema version {schema_version_raw!r}; "
                f"supported versions are {sorted(SUPPORTED_MANIFEST_SCHEMA_VERSIONS)}."
            )
        sample_id = _read_text_field(record, "sample_id")
        corpus = _read_text_field(record, "corpus")
        audio_path_text = _read_text_field(record, "audio_path") or _read_text_field(
            record, "path"
        )
        if sample_id is None or corpus is None or audio_path_text is None:
            raise ManifestError(
                "Manifest record must include sample_id, corpus, and audio_path fields."
            )
        label_text = _read_text_field(record, "label")
        if schema_version_raw == 1 and label_text is None:
            raise ManifestError("Manifest schema v1 requires a categorical label.")
        label = normalize_label(label_text) if label_text is not None else None
        split_raw = _read_text_field(record, "split")
        native_split_raw = _read_text_field(record, "native_split")
        annotations_raw = record.get("annotations", [])
        if not isinstance(annotations_raw, list):
            raise ManifestError("Manifest 'annotations' must be a list.")
        annotations = tuple(TargetAnnotation.from_record(raw) for raw in annotations_raw)

        utterance = Utterance(
            sample_id=sample_id,
            corpus=corpus,
            audio_path=_resolve_audio_path(audio_path_text, base_dir),
            label=label,
            raw_label=_read_text_field(record, "raw_label"),
            vad=VadTarget.from_record(record.get("vad")),
            social_attitude=_read_text_field(record, "social_attitude"),
            binary_affect=_read_text_field(record, "binary_affect"),
            transcript=_read_text_field(record, "transcript"),
            annotations=annotations,
            speaker_id=_read_text_field(record, "speaker_id"),
            session_id=_read_text_field(record, "session_id"),
            language=_read_text_field(record, "language"),
            split=split_raw if split_raw in _SPLIT_NAMES else None,
            native_split=native_split_raw if native_split_raw in _SPLIT_NAMES else None,
            start_seconds=_read_optional_float_field(record, "start_seconds"),
            duration_seconds=_read_optional_float_field(record, "duration_seconds"),
            normalized_audio_sha256=_read_text_field(record, "normalized_audio_sha256"),
            dataset_revision=_read_text_field(record, "dataset_revision"),
            dataset_policy_id=_read_text_field(record, "dataset_policy_id"),
            dataset_license_id=_read_text_field(record, "dataset_license_id"),
            source_url=_read_text_field(record, "source_url"),
            schema_version=MANIFEST_SCHEMA_VERSION,
        )
        utterance.validate(ontology=ontology)
        return utterance

    def to_record(self, *, base_dir: Path | None = None) -> dict[str, object]:
        """Serializes one v1/v2 record for JSONL persistence."""
        path = (
            _maybe_relative(self.audio_path, base_dir)
            if base_dir is not None
            else str(self.audio_path)
        )
        record: dict[str, object] = {
            "schema_version": self.schema_version,
            "sample_id": self.sample_id,
            "corpus": self.corpus,
            "audio_path": path,
        }
        optional_fields: dict[str, object | None] = {
            "label": self.label,
            "raw_label": self.raw_label,
            "vad": self.vad.to_record() if self.vad is not None else None,
            "social_attitude": self.social_attitude,
            "binary_affect": self.binary_affect,
            "transcript": self.transcript,
            "annotations": (
                [annotation.to_record() for annotation in self.annotations]
                if self.annotations
                else None
            ),
            "speaker_id": self.speaker_id,
            "session_id": self.session_id,
            "language": self.language,
            "split": self.split,
            "native_split": self.native_split,
            "start_seconds": self.start_seconds,
            "duration_seconds": self.duration_seconds,
            "normalized_audio_sha256": self.normalized_audio_sha256,
            "dataset_revision": self.dataset_revision,
            "dataset_policy_id": self.dataset_policy_id,
            "dataset_license_id": self.dataset_license_id,
            "source_url": self.source_url,
        }
        record.update(
            (key, value) for key, value in optional_fields.items() if value is not None
        )
        return record


def normalized_pcm_sha256(audio: np.ndarray) -> str:
    """Content digest of the normalized float32 PCM (decode-invariant identity).

    Reference ``training_readiness.py:517-567``: digests are computed over the
    canonical normalized PCM so container/encoding changes don't shift sample
    identity.
    """
    canonical = np.ascontiguousarray(np.asarray(audio, dtype=np.float32))
    return sha256(canonical.tobytes()).hexdigest()


def load_manifest_jsonl(
    path: str | Path,
    *,
    ontology: LabelOntology | None = None,
    base_dir: Path | None = None,
) -> list[Utterance]:
    """Loads one JSONL manifest into validated utterance records.

    Reference ``manifest_jsonl.py:14-46``: blank lines and ``#`` comments are
    skipped, records must be JSON objects, and duplicate sample_ids are a
    hard error.
    """
    source = Path(path)
    if not source.exists():
        raise FileNotFoundError(f"Manifest not found: {path}")
    resolved_base = base_dir if base_dir is not None else source.parent
    utterances: list[Utterance] = []
    seen_ids: set[str] = set()
    with source.open("r", encoding="utf-8") as handle:
        for line_number, line in enumerate(handle, start=1):
            raw = line.strip()
            if not raw or raw.startswith("#"):
                continue
            try:
                payload = json.loads(raw)
            except json.JSONDecodeError as err:
                raise ManifestError(
                    f"Invalid JSON in manifest {path} at line {line_number}: {err}"
                ) from err
            if not isinstance(payload, dict):
                raise ManifestError(
                    f"Manifest {path} line {line_number} must be a JSON object."
                )
            # Legacy in-house header line (pre-interop manifests): tolerate.
            if set(payload) == {"manifest_schema_version"}:
                if payload["manifest_schema_version"] not in SUPPORTED_MANIFEST_SCHEMA_VERSIONS:
                    raise ManifestError(
                        f"Unsupported manifest schema version "
                        f"{payload['manifest_schema_version']!r} in {path}."
                    )
                continue
            utterance = Utterance.from_record(
                payload, base_dir=resolved_base, ontology=ontology
            )
            if utterance.sample_id in seen_ids:
                raise ManifestError(
                    f"Duplicate sample_id {utterance.sample_id!r} in manifest {path}."
                )
            seen_ids.add(utterance.sample_id)
            utterances.append(utterance)
    return utterances


def read_manifest_jsonl(
    path: str | Path, *, ontology: LabelOntology | None = None
) -> list[Utterance]:
    """Reads + validates one JSONL manifest (absolute-path resolution)."""
    return load_manifest_jsonl(path, ontology=ontology)


def write_manifest_jsonl(
    utterances: list[Utterance],
    path: str | Path,
    *,
    base_dir: Path | None = None,
    ontology: LabelOntology | None = None,
) -> str:
    """Writes one deterministic JSONL manifest in the reference wire format.

    Reference ``manifest_jsonl.py:49-63``: one sorted-key JSON object per
    line, optional fields omitted when absent, no header record.
    """
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    resolved_base = base_dir if base_dir is not None else target.parent
    with target.open("w", encoding="utf-8") as handle:
        for utterance in utterances:
            utterance.validate(ontology=ontology)
            record = utterance.to_record(base_dir=resolved_base)
            handle.write(json.dumps(record, sort_keys=True))
            handle.write("\n")
    return str(target)


__all__ = [
    "EXTENDED_LABELS",
    "MANIFEST_SCHEMA_VERSION",
    "SUPPORTED_MANIFEST_SCHEMA_VERSIONS",
    "ManifestError",
    "PRIMARY_EMOTIONS",
    "TargetAnnotation",
    "Utterance",
    "VadTarget",
    "default_manifest_ontology",
    "load_manifest_jsonl",
    "normalized_pcm_sha256",
    "read_manifest_jsonl",
    "write_manifest_jsonl",
]
