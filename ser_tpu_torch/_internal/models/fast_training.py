"""Fast-profile training: readiness, batched features → MLP head → artifact and report.

Counterpart of ``ser_tpu/_internal/models/fast_training.py``: the
entry point's readiness gate and the fast backend's smoke, then
``loader.load_data`` (the 193 features on the settings' device), the head's
fit (``TorchMLPClassifier`` on the settings' device), accuracy, macro-F1,
UAR, per-class recall and the confusion matrix, the v3 artifact and the
JSON report. ``train_from_prepared`` fits a head from a digest-validated
prepared plan, its split drawn as the JAX package's scikit-learn split draws
it (``_internal/data/split.py``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data import loader
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.train.metrics import accuracy, compute_ser_metrics
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.ops.features import feature_dim

logger = get_logger(__name__)


class TrainingDataError(RuntimeError):
    """Raised when training data cannot support a model fit."""


def _license_provenance(settings: AppConfig) -> dict[str, Any]:
    from ser_tpu_torch._internal.runtime.restricted_backends import build_provenance_metadata

    return build_provenance_metadata(
        settings=settings, backend_id="handcrafted", profile="fast"
    )


def train_fast_model(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Trains the fast-profile head end-to-end; returns the training report."""
    settings = settings if settings is not None else reload_settings()
    started = time.time()

    from contextlib import nullcontext

    from ser_tpu_torch._internal.models.training_orchestration import (
        current_training_run,
        ensure_entrypoint_readiness,
        training_operation_scope,
    )

    scope = (
        nullcontext()
        if current_training_run() is not None
        else training_operation_scope("fast")
    )
    with scope:
        ensure_entrypoint_readiness(settings=settings, profile="fast")
        return _train_fast_model_ready(settings, started)


def _train_fast_model_ready(settings: AppConfig, started: float) -> dict[str, Any]:
    split = loader.load_data(settings=settings)
    if split is None:
        raise TrainingDataError(
            "No trainable data found. Check SER_DATASET_FOLDER and dataset contents."
        )
    x_train, x_test, y_train, y_test = split
    logger.info(
        "Training fast head on %d samples (%d test), dim=%d",
        len(y_train),
        len(y_test),
        x_train.shape[1],
    )

    model = TorchMLPClassifier.from_config(settings.nn, device=resolve_device(settings.torch_runtime.device))
    model.fit(x_train, y_train)

    y_pred = [str(item) for item in model.predict(x_test)]
    metrics = compute_ser_metrics(y_true=y_test, y_pred=y_pred)
    # The JAX package's training_report.json keys.
    import glob as _glob
    from collections import Counter
    from datetime import UTC, datetime

    all_labels = [str(item) for item in (*y_train, *y_test)]
    corpus_samples = len(_glob.glob(settings.dataset.glob_pattern))
    effective_samples = len(y_train) + len(y_test)
    report: dict[str, Any] = {
        "profile": "fast",
        "backend_id": "handcrafted",
        "artifact_version": artifacts.MODEL_ARTIFACT_VERSION,
        "artifact_schema_version": artifacts.ARTIFACT_SCHEMA_VERSION,
        "created_at_utc": datetime.now(tz=UTC).isoformat(),
        "dataset_glob_pattern": settings.dataset.glob_pattern,
        "dataset_corpus_samples": corpus_samples,
        "dataset_effective_samples": effective_samples,
        "dataset_skipped_samples": max(0, corpus_samples - effective_samples),
        "accuracy": accuracy(y_test, y_pred),
        "uar": metrics["uar"],
        "macro_f1": metrics["macro_f1"],
        "per_class_recall": metrics["per_class_recall"],
        "confusion_matrix": metrics["confusion_matrix"],
        "metrics": metrics,
        "labels": sorted(set(all_labels)),
        "label_distribution": dict(Counter(all_labels)),
        "train_samples": len(y_train),
        "training_samples": len(y_train),
        "test_samples": len(y_test),
        "feature_vector_size": int(x_train.shape[1]),
        "n_iter": model.n_iter_,
        "final_loss": model.loss_,
        "elapsed_seconds": time.time() - started,
    }

    metadata = artifacts.build_artifact_metadata(
        feature_vector_size=int(x_train.shape[1]),
        training_samples=len(y_train),
        labels=sorted(set(y_train)),
        backend_id="handcrafted",
        profile="fast",
        feature_dim=feature_dim(settings.feature_flags),
        pooling_strategy="mean",
        # The device the features were computed and the head fitted on.
        device=resolve_device(settings.torch_runtime.device).type,
        dtype="float32",
        seed=settings.nn.random_state,
        provenance={
            "framework": "ser_tpu_torch",
            "trainer": "fast_training",
            **_license_provenance(settings),
        },
        evaluation_summary={
            "accuracy": report["accuracy"],
            "uar": report["uar"],
            "macro_f1": report["macro_f1"],
        },
    )
    envelope = artifacts.build_model_artifact(model, metadata)
    model_path = artifacts.save_model_artifact(envelope, settings.models.model_file)
    report["model_path"] = model_path
    report["artifact_metadata"] = metadata
    # The metadata sidecar stands in the secure slot: inspectable without unpickling.
    _target = Path(model_path)
    report["model_artifacts"] = {
        "pickle": str(model_path),
        "secure": str(_target.with_suffix(_target.suffix + ".meta.json")),
    }

    settings.models.folder.mkdir(parents=True, exist_ok=True)
    settings.models.training_report_file.write_text(
        json.dumps(report, indent=2, default=str), encoding="utf-8"
    )
    report["report_path"] = str(settings.models.training_report_file)
    logger.info(
        "Fast training done: accuracy=%.3f uar=%.3f macro_f1=%.3f (%d iters)",
        report["accuracy"],
        report["uar"],
        report["macro_f1"],
        model.n_iter_,
    )
    return report


def train_from_prepared(
    *, plan_path, settings: AppConfig, profile: str = "fast"
) -> dict[str, Any]:
    """Trains the head from a digest-validated prepared plan (resume path).

    Profile-aware: the plan's backend fingerprint is digest-validated against
    the ACTIVE runtime inside ``load_prepared_plan`` (an accurate plan cannot
    resume into a medium run), and the persisted artifact carries the real
    backend/model-id/pooling metadata so load-time compat filters keep
    working.
    """
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_names
    from ser_tpu_torch._internal.data.split import group_shuffle_indices, train_test_indices
    from ser_tpu_torch._internal.models.training_readiness import load_prepared_plan
    from ser_tpu_torch.profiles import require_ported

    features, labels, groups = load_prepared_plan(plan_path, settings=settings, profile=profile)
    spec = require_ported(profile)
    if groups is not None and len(set(groups)) >= 2:
        # Group-disjoint resume split: encoder plans carry per-window rows, and
        # sibling windows of one clip or speaker on both sides inflate the metrics.
        train_idx, test_idx = group_shuffle_indices(
            groups, test_size=settings.training.test_size, random_state=settings.training.random_state
        )
    else:
        try:
            train_idx, test_idx = train_test_indices(
                len(labels),
                test_size=settings.training.test_size,
                random_state=settings.training.random_state,
                stratify=labels if settings.training.stratify_split else None,
            )
        except ValueError:
            # Tiny classes: unstratified, as loader.load_data falls back.
            train_idx, test_idx = train_test_indices(
                len(labels), test_size=settings.training.test_size, random_state=settings.training.random_state
            )
    x_train, x_test = features[train_idx], features[test_idx]
    y_train = [labels[i] for i in train_idx]
    y_test = [labels[i] for i in test_idx]
    model = TorchMLPClassifier.from_config(settings.nn, device=resolve_device(settings.torch_runtime.device))
    model.fit(x_train, y_train)
    y_pred = [str(item) for item in model.predict(x_test)]
    metrics = compute_ser_metrics(y_true=y_test, y_pred=y_pred)
    report = {
        "profile": profile,
        "backend_id": spec.backend_id,
        "accuracy": accuracy(y_test, y_pred),
        "uar": metrics["uar"],
        "macro_f1": metrics["macro_f1"],
        "training_samples": len(y_train),
        "from_prepared_plan": str(plan_path),
    }
    metadata = artifacts.build_artifact_metadata(
        feature_vector_size=int(x_train.shape[1]),
        training_samples=len(y_train),
        labels=sorted(set(y_train)),
        backend_id=spec.backend_id,
        profile=profile,
        pooling_strategy="mean" if profile == "fast" else "mean_std",
        backend_model_id=settings.profile_model_id(profile) if profile != "fast" else spec.default_model_id,
        seed=settings.nn.random_state,
        provenance={
            "framework": "ser_tpu_torch",
            "trainer": "prepared_plan",
            **_license_provenance(settings),
        },
    )
    if profile == "fast":
        model_path = settings.models.model_file
    else:
        names = profile_artifact_file_names(profile=profile, model_id=settings.profile_model_id(profile))
        model_path = settings.models.folder / names[0]
    report["model_path"] = artifacts.save_model_artifact(
        artifacts.build_model_artifact(model, metadata), model_path
    )
    return report


__all__ = ["TrainingDataError", "train_fast_model", "train_from_prepared"]
