"""Leakage-safe split ledgers: dedupe, identity grouping, deterministic splits.

Counterpart of ``ser_tpu/_internal/data/dataset_audit.py``, with the same
counters, digests and order of findings: rows whose audio content repeats
are quarantined, speaker and session identities join into groups that no
split shares, rows without a group go to ``ssl_only``, corpora whose rows
all carry a valid native split keep it, and the rest get a seeded 70/15/15
grouped assignment. The ledger is checked for partition isolation (no group
and no content hash in two supervised splits) and class coverage, and the
report pins the manifest and ledger digests.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Literal

from ser_tpu_torch._internal.data.manifest import Utterance

LedgerSplit = Literal["train", "dev", "test", "ssl_only", "quarantined"]

_SUPERVISED: tuple[LedgerSplit, ...] = ("train", "dev", "test")


class DatasetAuditError(ValueError):
    """Raised when the manifest set cannot produce a defensible benchmark."""


@dataclass(frozen=True)
class SplitLedgerEntry:
    """Immutable split assignment for one manifest row."""

    sample_id: str
    corpus: str
    split: LedgerSplit
    group_id: str | None
    audio_sha256: str | None
    reason: str
    tasks: tuple[str, ...] = ()
    disposition: str = "accepted"

    def to_record(self) -> dict[str, object]:
        return {
            "sample_id": self.sample_id,
            "corpus": self.corpus,
            "split": self.split,
            "group_id": self.group_id,
            "audio_sha256": self.audio_sha256,
            "tasks": list(self.tasks),
            "disposition": self.disposition,
            "reason": self.reason,
        }


@dataclass(frozen=True)
class DatasetAuditReport:
    """The audited ledger with digests pinning manifest + assignment state.

    Recipe provenance fields are populated by :func:`audit_dataset_recipe`
    (the routing-aware path) and stay ``None`` for the recipe-less
    :func:`build_split_ledger`.
    """

    manifest_digest: str
    ledger_digest: str
    seed: int
    #: Producer-dependent histogram: :func:`build_split_ledger` fills split
    #: counts ({"train": N, ...}); :func:`audit_dataset_recipe` fills route
    #: DISPOSITION counts ({"accepted": N, "dropped": N, ...}). Consumers of
    #: a persisted report must key on the producing command, not assume one
    #: vocabulary.
    counters: dict[str, int]
    ledger: tuple[SplitLedgerEntry, ...]
    recipe_id: str | None = None
    recipe_revision: str | None = None
    recipe_digest: str | None = None

    def split_of(self, sample_id: str) -> LedgerSplit:
        for entry in self.ledger:
            if entry.sample_id == sample_id:
                return entry.split
        raise KeyError(sample_id)


def _manifest_digest(utterances: list[Utterance]) -> str:
    payload = [
        {
            "sample_id": u.sample_id,
            "corpus": u.corpus,
            "label": u.label,
            "speaker_id": u.speaker_id,
            "session_id": u.session_id,
            "audio_sha256": u.audio_sha256,
        }
        for u in sorted(utterances, key=lambda u: u.sample_id)
    ]
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _ledger_digest(entries: list[SplitLedgerEntry]) -> str:
    payload = [entry.to_record() for entry in sorted(entries, key=lambda e: e.sample_id)]
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _identity_groups(utterances: list[Utterance]) -> dict[str, str | None]:
    """sample_id → canonical identity group via speaker/session union-find.

    A speaker appearing under two session ids (or vice versa) must land in
    ONE group — otherwise the 'independent' groups leak the same voice across
    splits (reference ``dataset_audit.py:86-120``).
    """
    parent: dict[str, str] = {}

    def find(value: str) -> str:
        parent.setdefault(value, value)
        while parent[value] != value:
            parent[value] = parent[parent[value]]
            value = parent[value]
        return value

    def union(left: str, right: str) -> None:
        left_root, right_root = find(left), find(right)
        if left_root != right_root:
            parent[max(left_root, right_root)] = min(left_root, right_root)

    for utterance in utterances:
        identities = [
            value for value in (utterance.speaker_id, utterance.session_id) if value
        ]
        for identity in identities[1:]:
            union(identities[0], identity)
        if identities:
            find(identities[0])

    return {
        u.sample_id: (
            find(next(v for v in (u.speaker_id, u.session_id) if v))
            if (u.speaker_id or u.session_id)
            else None
        )
        for u in utterances
    }


def _group_assignments(group_ids: set[str], *, corpus: str, seed: int) -> dict[str, LedgerSplit]:
    """Deterministic 70/15/15 grouped split, ordered by seeded hash.

    Hash ordering (not sorted names) keeps the assignment stable under
    corpus growth while remaining independent of insertion order; tiny
    corpora degrade gracefully (1 group → train; 2 → train/test).
    """
    ordered = sorted(
        group_ids,
        key=lambda group: hashlib.sha256(f"{seed}:{corpus}:{group}".encode()).digest(),
    )
    count = len(ordered)
    if count == 1:
        return {ordered[0]: "train"}
    if count == 2:
        return {ordered[0]: "train", ordered[1]: "test"}
    train_count = max(1, min(count - 2, round(count * 0.70)))
    remaining = count - train_count
    dev_count = max(1, min(remaining - 1, round(count * 0.15)))
    return {
        group: (
            "train"
            if index < train_count
            else "dev"
            if index < train_count + dev_count
            else "test"
        )
        for index, group in enumerate(ordered)
    }


def _validate_partition_isolation(entries: list[SplitLedgerEntry]) -> None:
    """No identity group or content hash may span supervised splits."""
    supervised = [entry for entry in entries if entry.split in _SUPERVISED]
    for attribute in ("group_id", "audio_sha256"):
        owners: dict[str, LedgerSplit] = {}
        for entry in supervised:
            value = getattr(entry, attribute)
            if value is None:
                continue
            previous = owners.setdefault(value, entry.split)
            if previous != entry.split:
                raise DatasetAuditError(
                    f"Split leakage: {attribute} {value!r} appears in "
                    f"{previous!r} and {entry.split!r}."
                )


_VALID_NATIVE: frozenset[str] = frozenset(_SUPERVISED)


def build_split_ledger(
    utterances: list[Utterance],
    *,
    seed: int = 17,
    strict: bool = True,
) -> DatasetAuditReport:
    """Audits all rows and assigns each to exactly one ledger split.

    Strict mode rejects duplicate sample ids always, and escalates missing
    content hashes to errors; duplicate CONTENT quarantines in both modes
    (training on a clip that also sits in test is never defensible).
    """
    seen_ids: set[str] = set()
    by_content: defaultdict[str, list[str]] = defaultdict(list)
    for utterance in utterances:
        if utterance.sample_id in seen_ids:
            raise DatasetAuditError(
                f"Duplicate sample_id {utterance.sample_id!r} across manifests."
            )
        seen_ids.add(utterance.sample_id)
        if utterance.audio_sha256:
            by_content[utterance.audio_sha256].append(utterance.sample_id)

    duplicate_ids = {
        sample_id
        for group in by_content.values()
        if len(group) > 1
        for sample_id in group
    }
    missing_hashes = [u.sample_id for u in utterances if not u.audio_sha256]
    if strict and missing_hashes:
        raise DatasetAuditError(
            f"audio_sha256 is missing for {len(missing_hashes)} row(s); content "
            "dedupe cannot be proven."
        )

    entries: list[SplitLedgerEntry] = []
    by_corpus: defaultdict[str, list[Utterance]] = defaultdict(list)
    for utterance in utterances:
        by_corpus[utterance.corpus].append(utterance)

    for corpus, rows in sorted(by_corpus.items()):
        groups = _identity_groups(rows)
        eligible = [u for u in rows if u.sample_id not in duplicate_ids]
        official = bool(eligible) and all(
            (u.native_split or u.split) in _VALID_NATIVE for u in eligible
        )
        group_ids = {
            group for u in eligible if (group := groups[u.sample_id]) is not None
        }
        assignments = (
            {} if official else _group_assignments(group_ids, corpus=corpus, seed=seed)
        )
        for utterance in rows:
            group_id = groups[utterance.sample_id]
            if utterance.sample_id in duplicate_ids:
                split: LedgerSplit = "quarantined"
                reason = "duplicate_audio_content"
            elif official:
                split = (utterance.native_split or utterance.split)  # type: ignore[assignment]
                reason = "verified_native_split"
            elif group_id is None:
                split = "ssl_only"
                reason = "missing_speaker_or_session_group"
            else:
                split = assignments[group_id]
                reason = "deterministic_grouped_split"
            entries.append(
                SplitLedgerEntry(
                    sample_id=utterance.sample_id,
                    corpus=corpus,
                    split=split,
                    group_id=group_id,
                    audio_sha256=utterance.audio_sha256,
                    reason=reason,
                )
            )

    if len(entries) != len(utterances):
        raise DatasetAuditError("Internal audit accounting did not classify every row.")
    _validate_partition_isolation(entries)

    if strict:
        # Label-free rows (schema-v2 VAD-only) are out of scope for class
        # coverage: a None in either set would crash the join below, and a
        # {None, 'happy'} train set would falsely pass the two-class gate.
        by_id = {u.sample_id: u for u in utterances}
        train_labels = {
            label
            for e in entries
            if e.split == "train" and (label := by_id[e.sample_id].label) is not None
        }
        if len(train_labels) < 2:
            raise DatasetAuditError(
                "Training partition must contain at least two populated classes."
            )
        eval_labels = {
            label
            for e in entries
            if e.split in ("dev", "test")
            and (label := by_id[e.sample_id].label) is not None
        }
        missing = eval_labels - train_labels
        if missing:
            raise DatasetAuditError(
                "Evaluation classes absent from train: " + ", ".join(sorted(missing))
            )

    counters = Counter(entry.split for entry in entries)
    ordered = tuple(sorted(entries, key=lambda entry: entry.sample_id))
    return DatasetAuditReport(
        manifest_digest=_manifest_digest(utterances),
        ledger_digest=_ledger_digest(list(ordered)),
        seed=seed,
        counters=dict(sorted(counters.items())),
        ledger=ordered,
    )


def audit_dataset_recipe(
    utterances: list[Utterance],
    *,
    recipe,
    seed: int = 17,
    strict: bool = True,
) -> DatasetAuditReport:
    """Routing-aware audit: routes, deduplicates, and assigns ledger splits.

    Reference ``dataset_audit.py:159-313``: every row is routed through the
    recipe's per-corpus task policy; content duplicates quarantine in both
    modes; strict mode additionally rejects duplicate content, missing content
    hashes, and missing dataset revisions; identity grouping and split
    assignment are computed over ELIGIBLE rows only (dropped/missing/
    quarantined routes never influence the grouped split), and the ledger
    records each row's disposition + task set alongside its split. Strict
    class checks apply only to rows carrying the ``primary_emotion`` task.
    """
    from ser_tpu_torch._internal.data.recipe import route_utterance

    recipe.validate()
    seen_ids: set[str] = set()
    by_content: defaultdict[str, list[str]] = defaultdict(list)
    routes = []
    for utterance in utterances:
        if utterance.sample_id in seen_ids:
            raise DatasetAuditError(
                f"Duplicate sample_id {utterance.sample_id!r} across manifests."
            )
        seen_ids.add(utterance.sample_id)
        if utterance.audio_sha256:
            by_content[utterance.audio_sha256].append(utterance.sample_id)
        routes.append(route_utterance(utterance, recipe))

    duplicate_ids = {
        sample_id
        for group in by_content.values()
        if len(group) > 1
        for sample_id in group
    }
    if strict and duplicate_ids:
        raise DatasetAuditError(
            f"Duplicate normalized audio content detected for {len(duplicate_ids)} row(s)."
        )
    missing_hashes = [u.sample_id for u in utterances if not u.audio_sha256]
    if strict and missing_hashes:
        raise DatasetAuditError(
            f"audio_sha256 is missing for {len(missing_hashes)} row(s)."
        )
    if strict:
        missing_revisions = [u.sample_id for u in utterances if u.revision is None]
        if missing_revisions:
            raise DatasetAuditError(
                f"dataset revision is missing for {len(missing_revisions)} row(s)."
            )

    counters: Counter[str] = Counter(route.disposition for route in routes)
    by_corpus: defaultdict[str, list] = defaultdict(list)
    for route in routes:
        by_corpus[route.utterance.corpus].append(route)

    _INELIGIBLE = ("dropped", "missing", "quarantined")
    entries: list[SplitLedgerEntry] = []
    for corpus, corpus_routes in sorted(by_corpus.items()):
        groups = _identity_groups([route.utterance for route in corpus_routes])
        eligible = [
            route
            for route in corpus_routes
            if route.disposition not in _INELIGIBLE
            and route.utterance.sample_id not in duplicate_ids
        ]
        # Membership in _VALID_NATIVE, not mere presence: a corpus declaring
        # native_split="validation" would otherwise be deemed official, its
        # rows ledgered outside the train/dev/test vocabulary — bypassing
        # the leakage gate and silently dropped by apply_recipe_ledger. The
        # reference accepts any non-None value here (a latent bug on its
        # side); build_split_ledger already hardened the sibling check.
        official = bool(eligible) and all(
            (route.utterance.native_split or route.utterance.split) in _VALID_NATIVE
            for route in eligible
        )
        group_ids = {
            group
            for route in eligible
            if (group := groups[route.utterance.sample_id]) is not None
        }
        assignments = (
            {} if official else _group_assignments(group_ids, corpus=corpus, seed=seed)
        )
        for route in corpus_routes:
            utterance = route.utterance
            group_id = groups[utterance.sample_id]
            disposition = route.disposition
            if utterance.sample_id in duplicate_ids:
                split: LedgerSplit = "quarantined"
                reason = "duplicate_normalized_audio"
                counters[route.disposition] -= 1
                counters["quarantined"] += 1
                disposition = "quarantined"
            elif route.disposition in _INELIGIBLE:
                split = "quarantined"
                reason = route.reason
            elif official:
                split = utterance.native_split or utterance.split  # type: ignore[assignment]
                reason = "verified_native_split"
            elif group_id is None:
                split = "ssl_only"
                reason = "missing_speaker_or_session_group"
            else:
                split = assignments[group_id]
                reason = "deterministic_grouped_split"
            entries.append(
                SplitLedgerEntry(
                    sample_id=utterance.sample_id,
                    corpus=corpus,
                    split=split,
                    group_id=group_id,
                    audio_sha256=utterance.audio_sha256,
                    reason=reason,
                    tasks=tuple(sorted(route.tasks)),
                    disposition=disposition,
                )
            )

    if sum(counters.values()) != len(utterances):
        raise DatasetAuditError(
            "Internal audit accounting did not classify every manifest row."
        )
    _validate_partition_isolation(entries)

    if strict:
        by_id = {u.sample_id: u for u in utterances}
        train_labels = {
            label
            for entry in entries
            if entry.split == "train" and "primary_emotion" in entry.tasks
            if (label := by_id[entry.sample_id].label) is not None
        }
        if len(train_labels) < 2:
            raise DatasetAuditError(
                "Primary emotion training partition must contain at least two "
                "populated classes."
            )
        eval_labels = {
            label
            for entry in entries
            if entry.split in ("dev", "test") and "primary_emotion" in entry.tasks
            if (label := by_id[entry.sample_id].label) is not None
        }
        missing = eval_labels - train_labels
        if missing:
            raise DatasetAuditError(
                "Primary emotion evaluation classes are absent from train: "
                + ", ".join(sorted(missing))
            )

    ordered = tuple(sorted(entries, key=lambda entry: entry.sample_id))
    return DatasetAuditReport(
        manifest_digest=_manifest_digest(utterances),
        ledger_digest=_ledger_digest(list(ordered)),
        seed=seed,
        counters=dict(sorted(counters.items())),
        ledger=ordered,
        recipe_id=recipe.recipe_id,
        recipe_revision=recipe.revision,
        recipe_digest=recipe.digest,
    )


__all__ = [
    "DatasetAuditError",
    "DatasetAuditReport",
    "LedgerSplit",
    "SplitLedgerEntry",
    "audit_dataset_recipe",
    "build_split_ledger",
]
