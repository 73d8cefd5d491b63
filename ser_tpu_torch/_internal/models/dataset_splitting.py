"""Utterance-level train/test/dev splitting with the manifest, speaker and hash policy.

Counterpart of ``ser_tpu/_internal/models/dataset_splitting.py``, the same
ladder and provenance metadata:

1. ``manifest_split``: when every utterance carries an explicit ``split``,
   honour it (train and dev against test for the two-way split);
2. ``group_shuffle_split``: speaker-disjoint assignment over corpus-scoped
   speaker ids (``grouped_train_test_split``, drawn as scikit-learn's
   ``GroupShuffleSplit`` draws it), with a hard zero-overlap guard;
3. ``hash_stratified_split``: a per-label split ordered by a salted SHA-1 of
   the sample id (``SER_SPLIT_SALT``, default ``ser:<random_state>``), with
   no random state at all.

The three-way form keeps complete native train/dev/test assignments and
otherwise carves dev out of the two-way train side at a rescaled share.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from hashlib import sha1

import numpy as np

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data.loader import extract_ravdess_speaker_id_from_path
from ser_tpu_torch._internal.data.manifest import Utterance
from ser_tpu_torch._internal.train.eval import grouped_train_test_split

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SplitMetadata:
    """Split provenance carried into training reports and prepared plans."""

    split_strategy: str
    speaker_grouped: bool
    speaker_id_coverage: float
    train_unique_speakers: int
    test_unique_speakers: int
    speaker_overlap_count: int

    def as_dict(self) -> dict[str, object]:
        return {
            "split_strategy": self.split_strategy,
            "speaker_grouped": self.speaker_grouped,
            "speaker_id_coverage": self.speaker_id_coverage,
            "train_unique_speakers": self.train_unique_speakers,
            "test_unique_speakers": self.test_unique_speakers,
            "speaker_overlap_count": self.speaker_overlap_count,
        }


def resolve_corpus_scoped_speaker_id(utterance: Utterance) -> str | None:
    """Speaker id with RAVDESS filename fallback, scoped by corpus.

    Parity: reference ``dataset_splitting.py:171-181`` — the fallback id is
    prefixed ``"<corpus>:"`` so identical actor numbers across corpora never
    merge into one group.
    """
    if utterance.speaker_id is not None:
        return utterance.speaker_id
    if utterance.corpus != "ravdess":
        return None
    speaker_raw = extract_ravdess_speaker_id_from_path(str(utterance.audio_path))
    if speaker_raw is None:
        return None
    return f"{utterance.corpus}:{speaker_raw}"


def hash_for_split(sample_id: str, *, salt: str) -> int:
    """Deterministic 64-bit ordering token: SHA-1 of ``"<salt>|<sample_id>"``.

    Parity constant: reference ``dataset_splitting.py:183-187`` (first 8
    digest bytes, big-endian unsigned).
    """
    digest = sha1(f"{salt}|{sample_id}".encode()).digest()
    return int.from_bytes(digest[:8], byteorder="big", signed=False)


def split_salt(settings: AppConfig) -> str:
    """The split salt: ``SER_SPLIT_SALT`` env or ``ser:<random_state>``."""
    return os.getenv("SER_SPLIT_SALT", f"ser:{settings.training.random_state}").strip()


def hash_stratified_split(
    *,
    samples: list[Utterance],
    test_size: float,
    salt: str,
) -> tuple[list[Utterance], list[Utterance]]:
    """Deterministic per-label split ordered by salted sample-id hash.

    Per label (processed in sorted label order): samples sort by hash token,
    the first ``round(test_size * n)`` go to test (clamped to keep both sides
    non-empty within the label when n >= 2; singleton labels stay in train).
    Two global repair passes then guarantee neither side is empty overall.
    """
    by_label: dict[str, list[Utterance]] = {}
    for utterance in samples:
        by_label.setdefault(utterance.label, []).append(utterance)

    train: list[Utterance] = []
    test: list[Utterance] = []
    for _, group in sorted(by_label.items(), key=lambda item: item[0]):
        ordered = sorted(
            group, key=lambda utterance: hash_for_split(utterance.sample_id, salt=salt)
        )
        if len(ordered) < 2:
            train.extend(ordered)
            continue
        n_test = int(round(test_size * len(ordered)))
        n_test = min(max(n_test, 1), len(ordered) - 1)
        test.extend(ordered[:n_test])
        train.extend(ordered[n_test:])

    if not test and train:
        ordered = sorted(
            train, key=lambda utterance: hash_for_split(utterance.sample_id, salt=salt)
        )
        test.append(ordered.pop(0))
        train = ordered
    if not train and test:
        ordered = sorted(
            test, key=lambda utterance: hash_for_split(utterance.sample_id, salt=salt)
        )
        train.append(ordered.pop(0))
        test = ordered
    return train, test


def _speakers_of(
    partition: list[Utterance], speaker_by_id: dict[str, str | None]
) -> set[str]:
    return {
        speaker
        for utterance in partition
        if (speaker := speaker_by_id.get(utterance.sample_id)) is not None
    }


def split_utterances(
    *,
    samples: list[Utterance],
    settings: AppConfig,
) -> tuple[list[Utterance], list[Utterance], SplitMetadata]:
    """Two-way utterance split: manifest -> grouped -> salted hash."""
    if len(samples) < 2:
        raise RuntimeError("Training requires at least two labeled audio files.")

    labels = [utterance.label for utterance in samples]
    speaker_ids = [resolve_corpus_scoped_speaker_id(u) for u in samples]
    speaker_by_id = {
        utterance.sample_id: speaker
        for utterance, speaker in zip(samples, speaker_ids)
    }
    resolved = [item for item in speaker_ids if item is not None]
    coverage = len(resolved) / len(samples)

    if all(utterance.split is not None for utterance in samples):
        train = [u for u in samples if u.split in {"train", "dev"}]
        test = [u for u in samples if u.split == "test"]
        if train and test:
            train_speakers = _speakers_of(train, speaker_by_id)
            test_speakers = _speakers_of(test, speaker_by_id)
            return (
                train,
                test,
                SplitMetadata(
                    split_strategy="manifest_split",
                    speaker_grouped=False,
                    speaker_id_coverage=coverage,
                    train_unique_speakers=len(train_speakers),
                    test_unique_speakers=len(test_speakers),
                    speaker_overlap_count=len(train_speakers & test_speakers),
                ),
            )

    if len(resolved) == len(samples) and len(set(resolved)) >= 2:
        try:
            grouped = grouped_train_test_split(
                np.zeros((len(samples), 1), dtype=np.float64),
                labels,
                [str(item) for item in resolved],
                test_size=settings.training.test_size,
                random_state=settings.training.random_state,
            )
        except ValueError as err:
            logger.warning(
                "Grouped split failed (%s); falling back to deterministic hash split.",
                err,
            )
        else:
            train = [samples[int(i)] for i in grouped.train_indices]
            test = [samples[int(i)] for i in grouped.test_indices]
            train_speakers = _speakers_of(train, speaker_by_id)
            test_speakers = _speakers_of(test, speaker_by_id)
            overlap = len(train_speakers & test_speakers)
            if overlap > 0:
                raise RuntimeError(
                    "Grouped split produced overlapping speakers in train/test."
                )
            return (
                train,
                test,
                SplitMetadata(
                    split_strategy="group_shuffle_split",
                    speaker_grouped=True,
                    speaker_id_coverage=coverage,
                    train_unique_speakers=len(train_speakers),
                    test_unique_speakers=len(test_speakers),
                    speaker_overlap_count=overlap,
                ),
            )

    train, test = hash_stratified_split(
        samples=samples,
        test_size=settings.training.test_size,
        salt=split_salt(settings),
    )
    if not train or not test:
        raise RuntimeError(
            "Deterministic split produced an empty partition; adjust test_size."
        )
    train_speakers = _speakers_of(train, speaker_by_id)
    test_speakers = _speakers_of(test, speaker_by_id)
    return (
        train,
        test,
        SplitMetadata(
            split_strategy="hash_stratified_split",
            speaker_grouped=False,
            speaker_id_coverage=coverage,
            train_unique_speakers=len(train_speakers),
            test_unique_speakers=len(test_speakers),
            speaker_overlap_count=len(train_speakers & test_speakers),
        ),
    )


def split_utterances_three_way(
    *,
    samples: list[Utterance],
    settings: AppConfig,
) -> tuple[list[Utterance], list[Utterance], list[Utterance], SplitMetadata]:
    """Train/dev/test split preserving complete native assignments."""
    if samples and all(item.split is not None for item in samples):
        train = [item for item in samples if item.split == "train"]
        dev = [item for item in samples if item.split == "dev"]
        test = [item for item in samples if item.split == "test"]
        if train and dev and test:
            _, _, metadata = split_utterances(samples=samples, settings=settings)
            return (
                train,
                dev,
                test,
                replace(metadata, split_strategy="manifest_three_way_split"),
            )
    initial_train, test, metadata = split_utterances(samples=samples, settings=settings)
    relative_dev_size = settings.training.dev_size / (1.0 - settings.training.test_size)
    dev_settings = replace(
        settings,
        training=replace(settings.training, test_size=relative_dev_size),
    )
    train, dev, dev_metadata = split_utterances(
        samples=initial_train, settings=dev_settings
    )
    return (
        train,
        dev,
        test,
        replace(
            metadata,
            split_strategy=f"{metadata.split_strategy}+dev",
            speaker_overlap_count=max(
                metadata.speaker_overlap_count,
                dev_metadata.speaker_overlap_count,
            ),
        ),
    )


__all__ = [
    "SplitMetadata",
    "hash_for_split",
    "hash_stratified_split",
    "resolve_corpus_scoped_speaker_id",
    "split_salt",
    "split_utterances",
    "split_utterances_three_way",
]
