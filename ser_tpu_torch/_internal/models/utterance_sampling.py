"""Hierarchical utterance sampling and bounded per-epoch window selection.

Counterpart of ``ser_tpu/_internal/models/utterance_sampling.py`` (standard
library only): corpus weight ``sqrt(n_corpus)`` normalized over corpora,
class weight ``1/sqrt(n_class)`` normalized within each corpus, each
utterance's probability ``corpus_p * class_p / n_class``; the bounded window
selection is a ``random.Random`` draw keyed by ``sha256(seed:epoch:sample_id)``,
the same across processes, resumes and both packages.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass

__all__ = [
    "SamplingProbability",
    "UtteranceSamplingItem",
    "sampling_contributions",
    "select_training_windows",
    "utterance_sampling_distribution",
]


@dataclass(frozen=True)
class UtteranceSamplingItem:
    """Minimal utterance metadata needed by the balanced sampler."""

    sample_id: str
    corpus: str
    label: str
    window_count: int
    duration_seconds: float | None = None

    def validate(self) -> None:
        """Validates item identity and bounded integer window count."""
        if not self.sample_id.strip() or not self.corpus.strip() or not self.label.strip():
            raise ValueError("Sampling item identifiers and label must be non-empty.")
        if self.window_count <= 0:
            raise ValueError("Sampling item window_count must be positive.")
        if self.duration_seconds is not None and self.duration_seconds <= 0.0:
            raise ValueError("Sampling item duration_seconds must be positive when provided.")


@dataclass(frozen=True)
class SamplingProbability:
    """Expected contribution of one utterance under hierarchical sampling."""

    sample_id: str
    corpus: str
    label: str
    probability: float


def utterance_sampling_distribution(
    items: list[UtteranceSamplingItem],
) -> tuple[SamplingProbability, ...]:
    """Computes ``sqrt(corpus)`` / inverse-``sqrt(class)`` sampling probabilities."""
    if not items:
        raise ValueError("Cannot build a sampling distribution for an empty dataset.")

    corpus_sizes: dict[str, int] = {}
    cell_sizes: dict[tuple[str, str], int] = {}
    seen_ids: set[str] = set()
    for item in items:
        item.validate()
        if item.sample_id in seen_ids:
            raise ValueError(f"Duplicate sampling sample_id {item.sample_id!r}.")
        seen_ids.add(item.sample_id)
        corpus_sizes[item.corpus] = corpus_sizes.get(item.corpus, 0) + 1
        cell = (item.corpus, item.label)
        cell_sizes[cell] = cell_sizes.get(cell, 0) + 1

    corpus_mass = sum(math.sqrt(size) for size in corpus_sizes.values())
    class_mass = {
        corpus: sum(
            1.0 / math.sqrt(size)
            for (cell_corpus, _), size in cell_sizes.items()
            if cell_corpus == corpus
        )
        for corpus in corpus_sizes
    }

    rows = []
    for item in items:
        corpus_probability = math.sqrt(corpus_sizes[item.corpus]) / corpus_mass
        cell_size = cell_sizes[(item.corpus, item.label)]
        class_probability = (1.0 / math.sqrt(cell_size)) / class_mass[item.corpus]
        rows.append(
            SamplingProbability(
                sample_id=item.sample_id,
                corpus=item.corpus,
                label=item.label,
                probability=corpus_probability * class_probability / cell_size,
            )
        )

    total = sum(row.probability for row in rows)
    if not math.isclose(total, 1.0, rel_tol=1e-12, abs_tol=1e-12):
        raise RuntimeError(f"Sampling probabilities do not sum to one: {total!r}.")
    return tuple(sorted(rows, key=lambda row: row.sample_id))


def select_training_windows(
    *,
    sample_id: str,
    window_count: int,
    max_windows: int,
    seed: int,
    epoch: int = 0,
) -> tuple[int, ...]:
    """Selects a deterministic random bounded window subset for one epoch."""
    if not sample_id.strip():
        raise ValueError("sample_id must be non-empty.")
    if window_count <= 0 or max_windows <= 0:
        raise ValueError("window_count and max_windows must be positive.")
    if epoch < 0:
        raise ValueError("epoch must be non-negative.")
    if window_count <= max_windows:
        return tuple(range(window_count))
    digest = hashlib.sha256(f"{seed}:{epoch}:{sample_id}".encode()).digest()
    generator = random.Random(int.from_bytes(digest[:8], "big"))
    return tuple(sorted(generator.sample(range(window_count), max_windows)))


def sampling_contributions(
    items: list[UtteranceSamplingItem],
) -> dict[str, dict[str, float]]:
    """Reports expected sample and duration contributions by corpus and class."""
    durations = {item.sample_id: item.duration_seconds for item in items}
    corpus_totals: dict[str, float] = {}
    class_totals: dict[str, float] = {}
    duration_totals: dict[str, float] = {}
    for row in utterance_sampling_distribution(items):
        corpus_totals[row.corpus] = corpus_totals.get(row.corpus, 0.0) + row.probability
        class_key = f"{row.corpus}:{row.label}"
        class_totals[class_key] = class_totals.get(class_key, 0.0) + row.probability
        seconds = durations[row.sample_id]
        if seconds is not None:
            duration_totals[row.corpus] = (
                duration_totals.get(row.corpus, 0.0) + row.probability * seconds
            )
    return {
        "corpus": dict(sorted(corpus_totals.items())),
        "class": dict(sorted(class_totals.items())),
        "expected_duration_seconds": dict(sorted(duration_totals.items())),
    }
