"""Encoder-profile training: utterances → embeddings → windows → head → artifact.

Counterpart of ``ser_tpu/_internal/models/encoder_training.py`` for the
medium, accurate and accurate-research heads: readiness and the backend smoke
first, then the speaker-disjoint (or manifest) split, the encode on the
settings' device with the embedding cache (keyed by backend, model id,
device and dtype), per-window mean+std rows with the noise controls, the
head's fit (``TorchMLPClassifier`` on the settings' device), window and
grouped per-sample metrics, and the v3 artifact with its report, which
``api.infer`` serves and the JAX package loads. On the card the accurate
encode runs kernels K1 and K2 (one clip a call, as the JAX package's
Whisper backend encodes), the medium encode masked K2 across clips, and its
float32 retry K2-f32.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_names
from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data import loader
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.models.noise_controls import NoiseControlStats, apply_noise_controls
from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
from ser_tpu_torch._internal.repr import FeatureBackend
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device, resolve_feature_runtime
from ser_tpu_torch._internal.train.eval import speaker_disjoint_split
from ser_tpu_torch._internal.train.metrics import (
    accuracy,
    compute_grouped_ser_metrics_by_sample,
    compute_sample_level_ser_metrics,
    compute_ser_metrics,
)
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.profiles import ProfileName, require_ported

logger = get_logger(__name__)


def _license_provenance(settings, backend_id: str, profile: str) -> dict:
    from ser_tpu_torch._internal.runtime.restricted_backends import build_provenance_metadata

    return build_provenance_metadata(
        settings=settings, backend_id=backend_id, profile=profile
    )


def group_metrics_min_support() -> int:
    """Minimum per-group sample support for corpus/language metrics.

    ``SER_GROUP_METRICS_MIN_SUPPORT``, default 20; an invalid value reads as
    the default, and the floor is 1.
    """
    raw = os.getenv("SER_GROUP_METRICS_MIN_SUPPORT", "").strip()
    if not raw:
        return 20
    try:
        value = int(raw)
    except ValueError:
        return 20
    return max(1, value)


def _windowed_dataset(
    *,
    files: list[tuple[str, str, str | None]],  # (path, label, speaker)
    backend: FeatureBackend,
    settings: AppConfig,
    window_size: float,
    window_stride: float,
    cache=None,
) -> tuple[np.ndarray, list[str], list[str], NoiseControlStats]:
    """Per-window mean+std features with labels, sample ids, and noise stats."""
    min_std = settings.medium_training.min_window_std
    max_windows = settings.medium_training.max_windows_per_clip

    # Cache-probe, then encode the misses 64 clips a call: batched across
    # clips where the backend has ``encode_sequences`` (the wav2vec2 class),
    # clip by clip otherwise (Whisper: all of a clip's windows in one call).
    # Decoded audio lives only until its chunk encodes.
    from ser_tpu_torch._internal.repr.encode_util import encode_clips

    encode_chunk_clips = 64  # plenty for the cross-clip attention budget
    encoded_by_path: dict[str, object] = {}
    pending: list[str] = []
    pending_audio: dict[str, tuple[np.ndarray, int]] = {}

    def flush_pending() -> None:
        if not pending:
            return
        for path, encoded in zip(
            pending, encode_clips(backend, [pending_audio[p] for p in pending])
        ):
            encoded_by_path[path] = encoded
        if cache is not None:
            for path in pending:
                cache.store(path, encoded_by_path[path], audio=pending_audio[path][0])
        pending.clear()
        pending_audio.clear()

    from ser_tpu_torch._internal.models.training_orchestration import (
        bounded_retry_local_io,
        handle_sample_encoding_failure,
        record_cache_probe,
    )

    all_labels: list[str | None] = [label for _path, label, _speaker in files]
    quarantined_labels: list[str | None] = []
    quarantined_paths: set[str] = set()
    for path, label, _speaker in files:
        try:
            audio, sr = bounded_retry_local_io(
                lambda path=path: read_audio_file(
                    path, audio_read_config=settings.audio_read
                ),
                identity=path,
            )
        except Exception as err:  # noqa: BLE001 - containment is classified
            # A sample that vanished or went corrupt AFTER readiness may be
            # dropped only while every quarantine budget still holds.
            if handle_sample_encoding_failure(
                settings=settings,
                sample_path=path,
                label=label,
                error=err,
                all_labels=all_labels,
                quarantined_labels=quarantined_labels,
            ):
                quarantined_labels.append(label)
                quarantined_paths.add(path)
                continue
            raise
        if cache is not None:
            hit = cache.load(path, audio=audio)
            record_cache_probe(hit=hit is not None)
            if hit is not None:
                encoded_by_path[path] = hit
                continue
        pending.append(path)
        pending_audio[path] = (audio, sr)
        if len(pending) >= encode_chunk_clips:
            flush_pending()
    flush_pending()

    rows, labels, sample_ids = [], [], []
    noise_stats = NoiseControlStats()
    for path, label, _speaker in files:
        if path in quarantined_paths:
            continue
        encoded = encoded_by_path[path]
        windows = temporal_pooling_windows(
            encoded, window_size_seconds=window_size, window_stride_seconds=window_stride
        )
        pooled = mean_std_pool(encoded, windows)
        kept, _, clip_stats = apply_noise_controls(
            pooled, min_window_std=min_std, max_windows_per_clip=max_windows
        )
        noise_stats = noise_stats.merged(clip_stats)
        for row in kept:
            rows.append(row)
            labels.append(label)
            sample_ids.append(path)
    if not rows:
        raise RuntimeError("No training windows survived the noise controls.")
    return np.vstack(rows), labels, sample_ids, noise_stats


def train_encoder_profile_model(
    *,
    profile: ProfileName,
    settings: AppConfig | None = None,
    backend: FeatureBackend | None = None,
) -> dict[str, Any]:
    """Trains one encoder-backed profile head end to end.

    ``backend`` is the injection seam: a test passes a double, and readiness's
    smoke probes what training will use. The head is
    ``TorchMLPClassifier.from_config(settings.nn)`` on the settings' device.
    """
    settings = settings if settings is not None else reload_settings()
    spec = require_ported(profile)
    started = time.time()

    from ser_tpu_torch._internal.models.training_orchestration import (
        current_training_run,
        ensure_entrypoint_readiness,
        training_operation_scope,
    )
    from contextlib import nullcontext

    scope = (
        nullcontext() if current_training_run() is not None
        else training_operation_scope(profile)
    )
    with scope:
        ensure_entrypoint_readiness(settings=settings, profile=profile, backend=backend)
        return _train_encoder_profile_model_ready(
            profile=profile, settings=settings, backend=backend, spec=spec, started=started
        )


def _split_training_files(
    *,
    files: list[tuple[str, str, str | None]],
    settings: AppConfig,
) -> tuple[
    list[tuple[str, str, str | None]],
    list[tuple[str, str, str | None]],
    dict[str, Any],
]:
    """Train/test file split and its provenance.

    Manifest-attributed runs split by utterance
    (``dataset_splitting.split_utterances``: manifest split, then grouped,
    then salted hash); glob runs take the speaker-disjoint grouped split with
    its rare-class pullback.
    """
    from pathlib import Path

    from ser_tpu_torch._internal.models.dataset_splitting import split_utterances

    if settings.dataset.manifest_paths:
        try:
            utterances = loader.load_utterances(settings=settings) or []
        except Exception as err:  # noqa: BLE001 - fall back to file split
            logger.warning("Manifest split unavailable: %s", err)
            utterances = []
        # Recipe-audited runs take the ledger's split assignment; a failed
        # audit aborts training rather than degrading to an unaudited split.
        utterances = loader.apply_recipe_ledger(utterances, settings=settings) or []
        by_resolved = {str(Path(u.audio_path).resolve()): u for u in utterances}
        file_by_resolved = {str(Path(item[0]).resolve()): item for item in files}
        if by_resolved and set(file_by_resolved) <= set(by_resolved):
            samples = [by_resolved[key] for key in file_by_resolved]
            train_u, test_u, metadata = split_utterances(
                samples=samples, settings=settings
            )
            train = [
                file_by_resolved[str(Path(u.audio_path).resolve())] for u in train_u
            ]
            test = [
                file_by_resolved[str(Path(u.audio_path).resolve())] for u in test_u
            ]
            return train, test, metadata.as_dict()

    # Falling through means the manifest/ledger split was NOT used (no
    # manifests, load failure, or discovered files not covered by the
    # manifest rows). Any provenance digests stamped by apply_recipe_ledger
    # would now be a false claim on the artifact — clear them.
    from ser_tpu_torch._internal.models.training_orchestration import current_training_run

    run_state = current_training_run()
    if run_state is not None and run_state.recipe_digest is not None:
        logger.warning(
            "Audited recipe split not applied (files outside manifest "
            "coverage); clearing artifact provenance digests."
        )
        run_state.recipe_digest = None
        run_state.split_ledger_digest = None

    train, test = speaker_disjoint_split(
        files,
        speaker_of=lambda item: item[2] or item[0],
        label_of=lambda item: item[1],
        test_size=settings.training.test_size,
        random_state=settings.training.random_state,
    )
    resolved = [item[2] for item in files if item[2] is not None]
    train_speakers = {item[2] for item in train if item[2] is not None}
    test_speakers = {item[2] for item in test if item[2] is not None}
    speaker_grouped = len({item[2] or item[0] for item in files}) >= 2
    overlap = len(train_speakers & test_speakers)
    if speaker_grouped and overlap > 0:
        raise RuntimeError(
            "Grouped training split produced overlapping speakers in train/test."
        )
    return (
        train,
        test,
        {
            "split_strategy": (
                "group_shuffle_split"
                if speaker_grouped
                else "stratified_shuffle_split_fallback"
            ),
            "speaker_grouped": speaker_grouped,
            "speaker_id_coverage": len(resolved) / len(files),
            "train_unique_speakers": len(train_speakers),
            "test_unique_speakers": len(test_speakers),
            "speaker_overlap_count": overlap,
        },
    )


def _train_encoder_profile_model_ready(
    *, profile, settings, backend, spec, started
) -> dict[str, Any]:
    if backend is None:
        from ser_tpu_torch._internal.repr.encoders import build_encoder_backend

        backend = build_encoder_backend(profile, settings=settings)

    # Manifest-aware attribution (corpus, label, speaker), shared with readiness.
    from ser_tpu_torch._internal.models.training_readiness import _file_records

    records = _file_records(loader.discover_dataset_files(settings), settings)
    files = [
        (record.path, record.label, record.speaker)
        for record in records
        if record.label is not None
    ]
    groups_by_path = {
        record.path: (record.corpus, record.language or "unknown") for record in records
    }
    if not files:
        raise RuntimeError("No labeled dataset files found for encoder training.")

    train_files, test_files, split_metadata = _split_training_files(
        files=files, settings=settings
    )

    from ser_tpu_torch._internal.data.embedding_cache import EmbeddingCache

    runtime = resolve_feature_runtime(spec.backend_id, torch_runtime=settings.torch_runtime)
    # Keyed by device and dtype: the card's entries ("cuda") and the CPU's never alias.
    cache = EmbeddingCache(
        root=settings.tmp_folder / "embedding-cache",
        backend_id=spec.backend_id,
        model_id=settings.profile_model_id(profile) or "none",
        revision="local",
        device=runtime.device.type,
        dtype=runtime.dtype,
    )

    runtime_config = settings.profile_runtime(profile)  # type: ignore[arg-type]
    x_train, y_train, _, train_noise_stats = _windowed_dataset(
        files=train_files,
        backend=backend,
        settings=settings,
        window_size=runtime_config.pool_window_size_seconds,
        window_stride=runtime_config.pool_window_stride_seconds,
        cache=cache,
    )
    x_test, y_test, test_ids, test_noise_stats = _windowed_dataset(
        files=test_files,
        backend=backend,
        settings=settings,
        window_size=runtime_config.pool_window_size_seconds,
        window_stride=runtime_config.pool_window_stride_seconds,
        cache=cache,
    )

    model = TorchMLPClassifier.from_config(settings.nn, device=resolve_device(settings.torch_runtime.device))
    model.fit(x_train, y_train)
    y_pred = [str(item) for item in model.predict(x_test)]
    window_metrics = compute_ser_metrics(y_true=y_test, y_pred=y_pred)
    grouped = compute_sample_level_ser_metrics(
        y_true=y_test, y_pred=y_pred, sample_ids=test_ids
    )
    # Corpus and language breakdown over per-sample majority votes (min
    # support from SER_GROUP_METRICS_MIN_SUPPORT, default 20).
    min_support = group_metrics_min_support()
    corpus_ids = [groups_by_path[i][0] for i in test_ids]
    language_ids = [groups_by_path[i][1] for i in test_ids]
    group_metrics = {
        "by_corpus": compute_grouped_ser_metrics_by_sample(
            y_true=y_test,
            y_pred=y_pred,
            sample_ids=test_ids,
            group_ids=corpus_ids,
            min_support=min_support,
        ),
        "by_language": compute_grouped_ser_metrics_by_sample(
            y_true=y_test,
            y_pred=y_pred,
            sample_ids=test_ids,
            group_ids=language_ids,
            min_support=min_support,
        ),
    }

    # The resolved id (the settings' override wins): the id the backend loaded.
    model_id = settings.profile_model_id(profile)
    from collections import Counter
    from datetime import UTC, datetime

    report: dict[str, Any] = {
        "profile": profile,
        "backend_id": spec.backend_id,
        "backend_model_id": model_id,
        "artifact_version": artifacts.MODEL_ARTIFACT_VERSION,
        "artifact_schema_version": artifacts.ARTIFACT_SCHEMA_VERSION,
        "created_at_utc": datetime.now(tz=UTC).isoformat(),
        "train_samples": len(train_files),
        "test_samples": len(test_files),
        "label_distribution": dict(Counter([*y_train, *y_test])),
        "metrics": window_metrics,
        "accuracy": accuracy(y_test, y_pred),
        "uar": window_metrics["uar"],
        "macro_f1": window_metrics["macro_f1"],
        "per_class_recall": window_metrics["per_class_recall"],
        "grouped": {
            "uar": grouped["uar"],
            "macro_f1": grouped["macro_f1"],
            "samples_evaluated": grouped["samples_evaluated"],
        },
        "group_metrics": group_metrics,
        "split_metadata": split_metadata,
        "train_noise_stats": train_noise_stats.as_dict(),
        "test_noise_stats": test_noise_stats.as_dict(),
        "labels": window_metrics["labels"],
        "training_windows": len(y_train),
        "test_windows": len(y_test),
        "feature_vector_size": int(x_train.shape[1]),
        "elapsed_seconds": time.time() - started,
    }
    from ser_tpu_torch._internal.models.training_orchestration import current_training_run

    run_state = current_training_run()
    if run_state is not None:
        # The report carries the containment audit trail.
        report["containment"] = dict(sorted(run_state.containment_counts.items()))
        report["cache_probes"] = {
            "hits": run_state.cache_hits,
            "misses": run_state.cache_misses,
        }
        if run_state.quarantined_sample_paths:
            report["quarantined_mid_training"] = sorted(
                run_state.quarantined_sample_paths
            )

    metadata = artifacts.build_artifact_metadata(
        feature_vector_size=int(x_train.shape[1]),
        training_samples=len(y_train),
        labels=sorted(set(y_train)),
        backend_id=spec.backend_id,
        profile=profile,
        # The classifier's input width (pooled), not the encoder's: the load
        # requires feature_dim == feature_vector_size.
        feature_dim=int(x_train.shape[1]),
        frame_size_seconds=runtime_config.pool_window_size_seconds,
        frame_stride_seconds=runtime_config.pool_window_stride_seconds,
        pooling_strategy="mean_std",
        backend_model_id=model_id,
        device=runtime.device.type,
        dtype=runtime.dtype,
        seed=settings.nn.random_state,
        provenance={
            # The JAX package's keys; the framework names the package that trained the head.
            "framework": "ser_tpu_torch",
            "trainer": "encoder_training",
            # License and access facts at training time.
            **_license_provenance(settings, spec.backend_id, profile),
        },
        evaluation_summary={
            "accuracy": report["accuracy"],
            "uar": report["uar"],
            "macro_f1": report["macro_f1"],
        },
        # Audited-recipe provenance (set by loader.apply_recipe_ledger when a
        # recipe run passed its audit), absent on other runs.
        recipe_digest=run_state.recipe_digest if run_state else None,
        split_ledger_digest=run_state.split_ledger_digest if run_state else None,
    )
    names = profile_artifact_file_names(profile=profile, model_id=model_id)
    model_path = artifacts.save_model_artifact(
        artifacts.build_model_artifact(model, metadata),
        settings.models.folder / names[0],
    )
    report["model_path"] = model_path
    report_path = settings.models.folder / names[2]
    report_path.write_text(json.dumps(report, indent=2, default=str), encoding="utf-8")
    report["report_path"] = str(report_path)
    logger.info(
        "%s training done: window-uar=%.3f grouped-uar=%.3f",
        profile,
        report["uar"],
        report["grouped"]["uar"],
    )
    return report


__all__ = ["train_encoder_profile_model"]
