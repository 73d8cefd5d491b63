"""RAVDESS-style dataset loading with batched feature extraction on the settings' device.

Counterpart of ``ser_tpu/_internal/data/loader.py``: glob discovery united
with manifest rows, the emotion code and speaker id read from RAVDESS file
names, threaded decoding under the failure-ratio budget
(``SER_MAX_FAILED_FILE_RATIO``), the 193 features of every decoded clip in
few device calls (``ops/features.extract_feature_vectors_batch``, on the
device ``SER_TORCH_DEVICE`` resolves to), the stratified train/test split
with the unstratified fallback, manifest utterances, and the audited
recipe's ledger. The split is ``split.train_test_indices``, which draws as
scikit-learn's ``train_test_split`` does: the port does not import
scikit-learn.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
from numpy.typing import NDArray

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data.ravdess import extract_ravdess_emotion_code
from ser_tpu_torch._internal.data.split import train_test_indices
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.ops.features import extract_feature_vectors_batch

logger = get_logger(__name__)

type SplitData = tuple[NDArray[np.float64], NDArray[np.float64], list[str], list[str]]


class LoadedClip(NamedTuple):
    """One decoded training clip with its label and provenance."""

    features: NDArray[np.float64]
    label: str
    file_path: str
    speaker_id: str | None


def _resolve_settings(settings: AppConfig | None) -> AppConfig:
    return settings if settings is not None else reload_settings()


def extract_ravdess_speaker_id_from_path(file_path: str) -> str | None:
    """Actor id is the 7th dash-separated field of the basename."""
    parts = os.path.basename(file_path).split("-")
    if len(parts) < 7:
        return None
    speaker = parts[6].split(".")[0].strip()
    return speaker or None


def discover_dataset_files(settings: AppConfig | None = None) -> list[str]:
    """Sorted dataset audio files: the configured glob UNION manifest rows.

    Manifest-configured corpora live wherever their ``audio_path`` columns
    point — often outside the RAVDESS ``Actor_*`` glob — and must still be
    visible to training readiness and the loaders.
    """
    settings = _resolve_settings(settings)
    files = set(glob.glob(settings.dataset.glob_pattern))
    if settings.dataset.manifest_paths:
        try:
            for utterance in load_utterances(settings=settings) or []:
                files.add(str(utterance.audio_path))
        except Exception as err:  # noqa: BLE001 - manifest defects surface later
            logger.warning("Manifest discovery unavailable: %s", err)
    return sorted(files)


def load_labeled_clips(
    *,
    settings: AppConfig | None = None,
    files: list[str] | None = None,
) -> list[LoadedClip]:
    """Decodes + batch-extracts features for every labeled dataset file.

    Enforces the configured failure-ratio budget: silently training on a
    heavily degraded dataset would produce a plausible-looking but broken
    model.
    """
    settings = _resolve_settings(settings)
    files = discover_dataset_files(settings) if files is None else files
    if not files:
        logger.warning("No dataset files found under %s", settings.dataset.glob_pattern)
        return []

    emotion_map = dict(settings.emotions)
    labeled_files: list[tuple[str, str]] = []
    for file in files:
        code = extract_ravdess_emotion_code(os.path.basename(file))
        label = emotion_map.get(code or "")
        if label is not None:
            labeled_files.append((file, label))

    errors: list[str] = []
    decoded: list[tuple[str, str, np.ndarray, int]] = []

    def decode(item: tuple[str, str]):
        file, label = item
        try:
            audio, sr = read_audio_file(file, audio_read_config=settings.audio_read)
            return (file, label, audio, sr)
        except Exception as err:  # noqa: BLE001 - every decode failure is budgeted
            return f"{file}: {err}"

    max_workers = max(1, min(settings.data_loader.max_workers, len(labeled_files) or 1))
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for result in pool.map(decode, labeled_files):
            if isinstance(result, str):
                errors.append(result)
            else:
                decoded.append(result)

    clips: list[LoadedClip] = []
    if decoded:
        try:
            matrix = extract_feature_vectors_batch(
                [(audio, sr) for _, _, audio, sr in decoded],
                device=resolve_device(settings.torch_runtime.device),
                feature_flags=settings.feature_flags,
            )
        except Exception as err:
            raise RuntimeError(f"Batched feature extraction failed: {err}") from err
        for row, (file, label, _, _) in enumerate(decoded):
            clips.append(
                LoadedClip(
                    features=matrix[row],
                    label=label,
                    file_path=file,
                    speaker_id=extract_ravdess_speaker_id_from_path(file),
                )
            )

    if errors:
        logger.warning("Skipped %s/%s files during feature extraction.", len(errors), len(labeled_files))
        for error in errors[:5]:
            logger.warning("%s", error)
    total = len(labeled_files)
    if total:
        failure_ratio = len(errors) / float(total)
        if failure_ratio > settings.data_loader.max_failed_file_ratio:
            raise RuntimeError(
                "Aborting data load: "
                f"{failure_ratio * 100.0:.1f}% file failures exceeded configured limit "
                f"{settings.data_loader.max_failed_file_ratio * 100.0:.1f}%. "
                "You can relax this limit by increasing the SER_MAX_FAILED_FILE_RATIO "
                "environment variable."
            )
    return clips


def load_data(
    test_size: float | None = None,
    *,
    settings: AppConfig | None = None,
) -> SplitData | None:
    """Loads the fast-profile training split: (x_train, x_test, y_train, y_test).

    Stratified when configured, with deterministic fallback to a plain split
    when stratification is infeasible (tiny classes).
    """
    settings = _resolve_settings(settings)
    clips = load_labeled_clips(settings=settings)
    if not clips:
        return None
    labels = [clip.label for clip in clips]
    if len(set(labels)) < 2:
        logger.warning("At least two emotion classes are required to train the model.")
        return None

    features = np.asarray([clip.features for clip in clips], dtype=np.float64)
    resolved_test_size = test_size if test_size is not None else settings.training.test_size

    stratify = labels if settings.training.stratify_split else None
    try:
        train, test = train_test_indices(
            len(labels), test_size=resolved_test_size, random_state=settings.training.random_state, stratify=stratify
        )
    except ValueError as err:
        logger.warning("Stratified split failed (%s). Falling back to non-stratified split.", err)
        train, test = train_test_indices(
            len(labels), test_size=resolved_test_size, random_state=settings.training.random_state
        )
    return features[train], features[test], [labels[i] for i in train], [labels[i] for i in test]


def load_utterances(
    *,
    settings: AppConfig | None = None,
    allow_prepare: bool = True,
):
    """Loads manifest utterances when configured, else RAVDESS glob discovery.

    Reference ``data_loader.py:199-208`` semantics: configured manifests win;
    otherwise the dataset folder is scanned and utterances synthesized from
    RAVDESS filenames. Returns ``list[Utterance] | None``.
    """
    from ser_tpu_torch._internal.data.manifest import Utterance, read_manifest_jsonl

    settings = _resolve_settings(settings)
    if settings.dataset.manifest_paths:
        utterances = []
        for manifest in settings.dataset.manifest_paths:
            utterances.extend(read_manifest_jsonl(manifest))
        # Reference data_loader.py:64-73: cross-manifest duplicate ids are a
        # hard error even without a recipe — two rows claiming one identity
        # make every downstream split/cache/ledger ambiguous.
        seen: set[str] = set()
        duplicates: set[str] = set()
        for utterance in utterances:
            if utterance.sample_id in seen:
                duplicates.add(utterance.sample_id)
            seen.add(utterance.sample_id)
        if duplicates:
            raise RuntimeError(
                "Duplicate sample_id values across manifests: " + ", ".join(sorted(duplicates))
            )
        return utterances or None

    from ser_tpu_torch._internal.data.ontology import remap_label, resolve_label_ontology

    emotion_map = dict(settings.emotions)
    ontology = resolve_label_ontology(settings)
    utterances = []
    for file in discover_dataset_files(settings):
        code = extract_ravdess_emotion_code(os.path.basename(file))
        if code is None:
            continue
        label = remap_label(raw_label=code, mapping=emotion_map, ontology=ontology)
        if label is None:
            continue
        utterances.append(
            Utterance(
                sample_id=os.path.splitext(os.path.basename(file))[0],
                corpus="ravdess",
                audio_path=file,
                label=label,
                raw_label=code,
                # Corpus-scoped (reference ravdess.py:87).
                speaker_id=(
                    f"ravdess:{sp}"
                    if (sp := extract_ravdess_speaker_id_from_path(file))
                    else None
                ),
                language=settings.default_language,
            )
        )
    return utterances or None


def apply_recipe_ledger(
    utterances,
    *,
    settings: AppConfig | None = None,
):
    """Reassigns splits from the audited recipe ledger when a recipe is set.

    Reference ``data_loader.py:74-99``: with ``--dataset-recipe``, the split
    assignment recorded in the leakage-audited ledger REPLACES whatever the
    manifests carried, and only rows routed to the ``primary_emotion`` task in
    a supervised partition survive into training. Raises
    ``DatasetAuditError`` when the set cannot produce a defensible benchmark
    (strict mode) — training must abort, not silently degrade.
    """
    import dataclasses

    from ser_tpu_torch._internal.data.dataset_audit import audit_dataset_recipe
    from ser_tpu_torch._internal.data.recipe import load_dataset_recipe

    settings = _resolve_settings(settings)
    if not settings.dataset.recipe or not utterances:
        return utterances
    recipe = load_dataset_recipe(settings.dataset.recipe)
    report = audit_dataset_recipe(
        utterances,
        recipe=recipe,
        seed=settings.training.random_state,
        strict=settings.dataset.strict_audit,
    )
    by_id = {utterance.sample_id: utterance for utterance in utterances}
    kept = [
        dataclasses.replace(by_id[entry.sample_id], split=entry.split)
        for entry in report.ledger
        if "primary_emotion" in entry.tasks
        and entry.split in ("train", "dev", "test")
        and by_id[entry.sample_id].label is not None
    ]
    # Stamp audited provenance onto the active training run so artifact
    # metadata can carry the reference's v3 recipe_digest/split_ledger_digest
    # fields.
    from ser_tpu_torch._internal.models.training_orchestration import current_training_run

    run_state = current_training_run()
    if run_state is not None:
        run_state.recipe_digest = report.recipe_digest
        run_state.split_ledger_digest = report.ledger_digest
    logger.info(
        "Dataset audit passed (recipe=%s@%s recipe_digest=%s ledger_digest=%s counters=%s).",
        report.recipe_id,
        report.recipe_revision,
        report.recipe_digest,
        report.ledger_digest,
        report.counters,
    )
    if not kept:
        logger.warning("Dataset recipe produced zero primary-emotion training rows.")
    return kept


__all__ = [
    "LoadedClip",
    "apply_recipe_ledger",
    "discover_dataset_files",
    "extract_ravdess_emotion_code",
    "extract_ravdess_speaker_id_from_path",
    "load_data",
    "load_labeled_clips",
    "load_utterances",
]
