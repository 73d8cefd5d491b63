"""SER evaluation metrics in numpy.

Counterpart of ``ser_tpu/_internal/train/metrics.py``: UAR (macro recall),
macro F1, per-class recall and the confusion matrix in a given label order;
accuracy; and the per-sample majority-vote metrics (ties go to the
lexically smallest label), grouped by corpus or language with a minimum
support, or flat.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Sequence

import numpy as np


def _confusion(y_true: list[str], y_pred: list[str], labels: list[str]) -> np.ndarray:
    index = {label: i for i, label in enumerate(labels)}
    matrix = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for true, pred in zip(y_true, y_pred):
        if true in index and pred in index:
            matrix[index[true], index[pred]] += 1
    return matrix


def compute_ser_metrics(
    *,
    y_true: Sequence[str],
    y_pred: Sequence[str],
    labels: Sequence[str] | None = None,
) -> dict[str, object]:
    """Computes UAR, macro-F1, per-class recall, and the confusion matrix."""
    if len(y_true) != len(y_pred):
        raise ValueError(
            "Expected y_true and y_pred to have the same length; "
            f"got {len(y_true)} and {len(y_pred)}."
        )
    if not y_true:
        raise ValueError("Expected non-empty label sequences for metric computation.")

    y_true = [str(item) for item in y_true]
    y_pred = [str(item) for item in y_pred]
    label_order = (
        [str(label) for label in labels] if labels is not None else sorted({*y_true, *y_pred})
    )
    confusion = _confusion(y_true, y_pred, label_order)

    recalls, f1s, per_class_recall = [], [], {}
    for i, label in enumerate(label_order):
        tp = float(confusion[i, i])
        support = float(confusion[i].sum())
        predicted = float(confusion[:, i].sum())
        recall = tp / support if support > 0 else 0.0
        precision = tp / predicted if predicted > 0 else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        recalls.append(recall)
        f1s.append(f1)
        per_class_recall[label] = float(recall)

    return {
        "labels": label_order,
        "uar": float(np.mean(recalls)),
        "macro_f1": float(np.mean(f1s)),
        "per_class_recall": per_class_recall,
        "confusion_matrix": confusion.tolist(),
    }


def accuracy(y_true: Sequence[str], y_pred: Sequence[str]) -> float:
    """Plain accuracy over string labels."""
    if not y_true:
        raise ValueError("Expected non-empty label sequences.")
    return float(
        np.mean([str(t) == str(p) for t, p in zip(y_true, y_pred, strict=True)])
    )


def _mode(values: list[str]) -> str:
    """Majority vote with the reference's deterministic tie-break: highest
    count first, then lexicographically smallest label
    (reference ``train/metrics.py:117-123``)."""
    counts: dict[str, int] = {}
    for value in values:
        counts[value] = counts.get(value, 0) + 1
    return sorted(counts.items(), key=lambda item: (-item[1], item[0]))[0][0]


def compute_grouped_ser_metrics_by_sample(
    *,
    y_true: Sequence[str],
    y_pred: Sequence[str],
    sample_ids: Sequence[str],
    group_ids: Sequence[str],
    min_support: int,
) -> dict[str, object]:
    """Per-group (corpus/language) metrics over per-sample majority votes.

    Parity surface: reference ``train/metrics.py:76-162`` — window-level
    inputs are aggregated per sample id by majority vote (labels, predictions,
    AND group ids each voted independently), samples are then grouped by the
    voted group id, and groups with fewer than ``min_support`` samples are
    reported under ``excluded`` instead of receiving metrics.
    """
    if not (len(y_true) == len(y_pred) == len(sample_ids) == len(group_ids)):
        raise ValueError("y_true/y_pred/sample_ids/group_ids must have equal length")
    if min_support < 1:
        raise ValueError("min_support must be >= 1")
    if not y_true:
        return {
            "unit": "samples",
            "min_support": min_support,
            "included": {},
            "excluded": {},
        }

    per_sample: dict[str, tuple[list[str], list[str], list[str]]] = {}
    for true, pred, sample, group in zip(
        y_true, y_pred, sample_ids, group_ids, strict=True
    ):
        trues, preds, groups = per_sample.setdefault(str(sample), ([], [], []))
        trues.append(str(true))
        preds.append(str(pred))
        groups.append(str(group))

    grouped_true: dict[str, list[str]] = {}
    grouped_pred: dict[str, list[str]] = {}
    for sample_id in sorted(per_sample):
        trues, preds, groups = per_sample[sample_id]
        grouped_true.setdefault(_mode(groups), []).append(_mode(trues))
        grouped_pred.setdefault(_mode(groups), []).append(_mode(preds))

    included: dict[str, object] = {}
    excluded: dict[str, object] = {}
    for group_id in sorted(grouped_true):
        support = len(grouped_true[group_id])
        if support < min_support:
            excluded[group_id] = {"support": support}
            continue
        included[group_id] = {
            "support": support,
            "metrics": compute_ser_metrics(
                y_true=grouped_true[group_id],
                y_pred=grouped_pred[group_id],
            ),
        }
    return {
        "unit": "samples",
        "min_support": min_support,
        "included": included,
        "excluded": excluded,
    }


def compute_sample_level_ser_metrics(
    *,
    y_true: Sequence[str],
    y_pred: Sequence[str],
    sample_ids: Sequence[str],
    min_support: int = 1,
) -> dict[str, object]:
    """Majority-vote per-sample metrics (window predictions → clip label).

    Flat (ungrouped) companion to :func:`compute_grouped_ser_metrics_by_sample`
    used by training reports and the quality gate: windows vote within each
    sample id; ties resolve lexically. Samples with fewer than ``min_support``
    windows are excluded.
    """
    if not (len(y_true) == len(y_pred) == len(sample_ids)):
        raise ValueError("y_true, y_pred, and sample_ids must have identical lengths.")
    if not y_true:
        raise ValueError("Expected non-empty label sequences.")

    per_sample: dict[str, tuple[list[str], list[str]]] = {}
    for true, pred, sample in zip(y_true, y_pred, sample_ids):
        trues, preds = per_sample.setdefault(str(sample), ([], []))
        trues.append(str(true))
        preds.append(str(pred))

    sample_true, sample_pred = [], []
    excluded = 0
    for sample_id in sorted(per_sample):
        trues, preds = per_sample[sample_id]
        if len(preds) < min_support:
            excluded += 1
            continue
        counts = Counter(preds)
        top = max(counts.values())
        sample_pred.append(sorted(label for label, c in counts.items() if c == top)[0])
        true_counts = Counter(trues)
        true_top = max(true_counts.values())
        # Lexical tie-break on BOTH sides: most_common() breaks ties by
        # insertion order, making metrics depend on window order.
        sample_true.append(
            sorted(label for label, c in true_counts.items() if c == true_top)[0]
        )

    if not sample_true:
        raise ValueError("No samples met the minimum support threshold.")
    metrics = compute_ser_metrics(y_true=sample_true, y_pred=sample_pred)
    metrics["samples_evaluated"] = len(sample_true)
    metrics["samples_excluded"] = excluded
    return metrics


__all__ = [
    "accuracy",
    "compute_grouped_ser_metrics_by_sample",
    "compute_sample_level_ser_metrics",
    "compute_ser_metrics",
]
