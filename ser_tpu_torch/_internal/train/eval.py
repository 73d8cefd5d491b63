"""Speaker-grouped splitting for leakage-free evaluation.

Counterpart of ``ser_tpu/_internal/train/eval.py``: ``GroupedSplit``, the
RAVDESS speaker id, the same validation messages, ``grouped_train_test_split``
(the test share applies to the number of speakers), ``speaker_independent_cv``
(stratified speaker-group folds, shuffled), the quality gate's fold ladder
(``build_grouped_folds``: the folds, else one grouped holdout), and the
item-level ``speaker_disjoint_split`` (with its rare-class pullback) and
``stratified_group_folds``. The JAX package draws these with scikit-learn's
``GroupShuffleSplit``, ``StratifiedGroupKFold`` and ``train_test_split``;
the port draws the same indices in numpy (``_internal/data/split.py``), so
both packages assign every item alike for the same ``(test_size,
random_state)``.
"""

from __future__ import annotations

import warnings
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from pathlib import Path
from typing import TypeVar

import numpy as np

from ser_tpu_torch._internal.data.split import (
    group_shuffle_indices,
    stratified_group_kfold_indices,
    train_test_indices,
)

T = TypeVar("T")

FoldIndices = tuple[np.ndarray, np.ndarray]


@dataclass(frozen=True)
class GroupedSplit:
    """Train/test split output with explicit sample indices."""

    x_train: np.ndarray
    x_test: np.ndarray
    y_train: list[str]
    y_test: list[str]
    train_indices: np.ndarray
    test_indices: np.ndarray


def extract_ravdess_speaker_id(file_name: str) -> str | None:
    """Extracts the actor ID from a RAVDESS-style audio filename."""
    parts = Path(file_name).name.split("-")
    if len(parts) < 7:
        return None
    speaker_id = parts[6].split(".")[0].strip()
    return speaker_id or None


def _validate_grouped_inputs(features: np.ndarray, labels: Sequence[str], speaker_ids: Sequence[str]) -> None:
    """Validates grouped-split input arrays and sequence lengths."""
    if features.ndim != 2:
        raise ValueError("features must be a 2D matrix.")
    sample_count = int(features.shape[0])
    if sample_count == 0:
        raise ValueError("features must contain at least one sample.")
    if len(labels) != sample_count:
        raise ValueError("labels length must match number of feature rows.")
    if len(speaker_ids) != sample_count:
        raise ValueError("speaker_ids length must match number of feature rows.")
    if len(set(speaker_ids)) < 2:
        raise ValueError("At least two distinct speaker IDs are required.")


def grouped_train_test_split(
    features: np.ndarray,
    labels: Sequence[str],
    speaker_ids: Sequence[str],
    *,
    test_size: float,
    random_state: int,
) -> GroupedSplit:
    """Builds a train/test split with disjoint speaker groups."""
    if not 0.0 < test_size < 1.0:
        raise ValueError("test_size must be between 0 and 1.")
    _validate_grouped_inputs(features, labels, speaker_ids)
    train_idx, test_idx = group_shuffle_indices(speaker_ids, test_size=test_size, random_state=random_state)
    train_indices = np.asarray(train_idx, dtype=np.int64)
    test_indices = np.asarray(test_idx, dtype=np.int64)
    return GroupedSplit(
        x_train=np.asarray(features[train_indices], dtype=np.float64),
        x_test=np.asarray(features[test_indices], dtype=np.float64),
        y_train=[str(labels[index]) for index in train_indices.tolist()],
        y_test=[str(labels[index]) for index in test_indices.tolist()],
        train_indices=train_indices,
        test_indices=test_indices,
    )


def speaker_independent_cv(
    features: np.ndarray,
    labels: Sequence[str],
    speaker_ids: Sequence[str],
    *,
    n_splits: int = 5,
    random_state: int = 42,
) -> tuple[FoldIndices, ...]:
    """Builds stratified speaker-group cross-validation folds."""
    if n_splits < 2:
        raise ValueError("n_splits must be greater than or equal to 2.")
    _validate_grouped_inputs(features, labels, speaker_ids)
    smallest = int(np.min(np.unique(np.asarray(labels), return_counts=True)[1]))
    if smallest < n_splits:
        warnings.warn(
            f"The least populated class in y has only {smallest} members, which is less than n_splits={n_splits}.",
            UserWarning,
            stacklevel=2,
        )
    folds = stratified_group_kfold_indices(labels, speaker_ids, n_splits=n_splits, random_state=random_state)
    return tuple((np.asarray(train, dtype=np.int64), np.asarray(test, dtype=np.int64)) for train, test in folds)


def build_grouped_folds(
    *,
    labels: Sequence[str],
    speaker_ids: Sequence[str],
    n_splits: int,
    random_state: int,
    fallback_test_size: float,
) -> tuple[str, tuple[FoldIndices, ...]]:
    """Grouped folds with the quality gate's ladder: stratified group k-fold,
    else (too few speakers for ``n_splits``) one grouped holdout fold."""
    if n_splits < 2:
        raise ValueError("n_splits must be greater than or equal to 2.")
    if not 0.0 < fallback_test_size < 1.0:
        raise ValueError("fallback_test_size must be between 0 and 1.")
    features = np.zeros((len(labels), 1), dtype=np.float64)
    try:
        folds = speaker_independent_cv(features, labels, speaker_ids, n_splits=n_splits, random_state=random_state)
        return "stratified_group_kfold", folds
    except ValueError:
        grouped_split = grouped_train_test_split(
            features, labels, speaker_ids, test_size=fallback_test_size, random_state=random_state
        )
        return "group_shuffle_holdout", ((grouped_split.train_indices, grouped_split.test_indices),)


def speaker_disjoint_split(
    items: Sequence[T],
    *,
    speaker_of: Callable[[T], str],
    label_of: Callable[[T], str] | None = None,
    test_size: float = 0.25,
    random_state: int = 42,
) -> tuple[list[T], list[T]]:
    """Splits items into speaker-disjoint train/test partitions.

    With two or more speakers, :func:`grouped_train_test_split`; with one,
    the stratified-then-plain ``train_test_split`` ladder. With ``label_of``,
    a class stranded entirely on the test side is pulled back by moving its
    smallest carrier speaker into train.
    """
    if not items:
        raise ValueError("Cannot split an empty item sequence.")
    if not (0.0 < test_size < 1.0):
        raise ValueError("test_size must be in (0, 1).")

    speakers: dict[str, list[T]] = {}
    for item in items:
        speakers.setdefault(str(speaker_of(item)), []).append(item)
    speaker_ids = [str(speaker_of(item)) for item in items]
    labels = [str(label_of(item)) if label_of is not None else "" for item in items]

    if len(speakers) < 2:
        if len(items) < 2:
            raise ValueError("Cannot split a single item into train and test partitions.")
        try:
            train_idx, test_idx = train_test_indices(
                len(items),
                test_size=test_size,
                random_state=random_state,
                stratify=labels if label_of is not None else None,
            )
        except ValueError:
            train_idx, test_idx = train_test_indices(len(items), test_size=test_size, random_state=random_state)
        return [items[int(i)] for i in train_idx], [items[int(i)] for i in test_idx]

    grouped = grouped_train_test_split(
        np.zeros((len(items), 1), dtype=np.float64),
        labels,
        speaker_ids,
        test_size=test_size,
        random_state=random_state,
    )
    test_speakers = {speaker_ids[int(i)] for i in grouped.test_indices}
    train = [items[int(i)] for i in grouped.train_indices]
    test = [items[int(i)] for i in grouped.test_indices]

    if label_of is not None:
        # Moving whole speakers keeps the partitions disjoint.
        def labels_of(side):
            return {str(label_of(item)) for item in side}

        missing = labels_of(test) - labels_of(train)
        while missing and len(test_speakers) > 1:
            carriers = sorted(
                (
                    speaker
                    for speaker in test_speakers
                    if any(str(label_of(item)) in missing for item in speakers[speaker])
                ),
                key=lambda speaker: (len(speakers[speaker]), speaker),
            )
            if not carriers:
                break
            test_speakers.discard(carriers[0])
            train = [item for item in items if str(speaker_of(item)) not in test_speakers]
            test = [item for item in items if str(speaker_of(item)) in test_speakers]
            missing = labels_of(test) - labels_of(train)
    return train, test


def stratified_group_folds(
    items: Sequence[T],
    *,
    speaker_of: Callable[[T], str],
    label_of: Callable[[T], str] | None = None,
    n_folds: int = 5,
    random_state: int = 42,
) -> list[tuple[list[T], list[T]]]:
    """Speaker-grouped K folds (the quality gate's ladder, :func:`build_grouped_folds`);
    without labels, the same ladder over uniform labels."""
    speakers = sorted({str(speaker_of(item)) for item in items})
    if len(speakers) < 2:
        raise ValueError(
            "Grouped cross-validation needs at least 2 speakers; got "
            f"{len(speakers)} (speaker-disjoint folds are impossible)."
        )
    n_folds = max(2, min(n_folds, len(speakers)))
    labels = [str(label_of(item)) if label_of is not None else "" for item in items]
    _, folds = build_grouped_folds(
        labels=labels,
        speaker_ids=[str(speaker_of(item)) for item in items],
        n_splits=n_folds,
        random_state=random_state,
        fallback_test_size=0.25,
    )
    out: list[tuple[list[T], list[T]]] = []
    for train_idx, test_idx in folds:
        train = [items[int(i)] for i in train_idx]
        test = [items[int(i)] for i in test_idx]
        if train and test:
            out.append((train, test))
    return out


__all__ = [
    "GroupedSplit",
    "build_grouped_folds",
    "extract_ravdess_speaker_id",
    "grouped_train_test_split",
    "speaker_disjoint_split",
    "speaker_independent_cv",
    "stratified_group_folds",
]
