"""Versioned cross-corpus dataset recipes, per-corpus task routing, and audits.

Counterpart of ``ser_tpu/_internal/data/recipe.py``: a recipe pins which
corpora take part, which of their labels may feed the primary emotion head
(exact or approximate), and which auxiliary tasks each corpus may feed;
``route_utterance`` gives every manifest row one disposition, so that no
incompatible label is forced into the primary classifier. ``digest`` is the
sha256 of the canonical JSON record (sorted keys, compact separators), byte
for byte the JAX package's: artifacts carry it.

The findings-level :func:`audit_recipe` is the training-readiness gate;
:func:`ser_tpu_torch._internal.data.dataset_audit.audit_dataset_recipe`
uses the routing to assign leak-proof splits.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

from ser_tpu_torch._internal.data.manifest import PRIMARY_EMOTIONS, Utterance
from ser_tpu_torch._internal.data.ontology import normalize_label

DATASET_RECIPE_SCHEMA_VERSION = 1

#: The canonical 8-class ontology a recipe may route into the primary head
#: (reference ``recipe.py:15-17``).
CANONICAL_EMOTIONS: frozenset[str] = frozenset(PRIMARY_EMOTIONS)

#: Every task a corpus policy may declare (reference ``recipe.py:19-41``).
TASK_NAMES: frozenset[str] = frozenset(
    {
        "primary_emotion",
        "raw_emotion",
        "vad",
        "attitude",
        "binary_affect",
        "language",
        "text_alignment",
        "ssl",
    }
)

#: Exhaustive routing outcomes (reference ``recipe.py:29``).
ROUTE_DISPOSITIONS: tuple[str, ...] = (
    "accepted",
    "remapped",
    "weak",
    "dropped",
    "missing",
    "quarantined",
)

#: Default per-class floor used by the findings-level audit.
MIN_CLIPS_PER_CLASS = 8


@dataclass(frozen=True)
class CorpusRecipe:
    """Task policy for one corpus (reference ``recipe.py:44-73``)."""

    corpus: str
    exact_primary_labels: frozenset[str] = frozenset()
    approximate_labels: frozenset[str] = frozenset()
    auxiliary_tasks: tuple[str, ...] = ()

    def validate(self) -> None:
        if not self.corpus.strip():
            raise ValueError("Corpus recipe id must be non-empty.")
        if self.exact_primary_labels - CANONICAL_EMOTIONS:
            raise ValueError(
                f"Corpus {self.corpus!r} contains non-canonical primary labels."
            )
        if self.exact_primary_labels & self.approximate_labels:
            raise ValueError(
                f"Corpus {self.corpus!r} has labels marked exact and approximate."
            )
        if "primary_emotion" in self.auxiliary_tasks:
            raise ValueError(
                "primary_emotion must be configured through exact_primary_labels."
            )
        if not set(self.auxiliary_tasks).issubset(TASK_NAMES):
            raise ValueError(
                f"Corpus {self.corpus!r} contains unsupported auxiliary tasks."
            )

    def to_record(self) -> dict[str, object]:
        return {
            "corpus": self.corpus,
            "exact_primary_labels": sorted(self.exact_primary_labels),
            "approximate_labels": sorted(self.approximate_labels),
            "auxiliary_tasks": list(self.auxiliary_tasks),
        }


@dataclass(frozen=True)
class DatasetRecipe:
    """Versioned declaration of corpora, ontology, and training tasks
    (reference ``recipe.py:76-127``)."""

    recipe_id: str
    revision: str
    ontology_version: str
    corpora: tuple[CorpusRecipe, ...]
    schema_version: int = DATASET_RECIPE_SCHEMA_VERSION

    def validate(self) -> None:
        if self.schema_version != DATASET_RECIPE_SCHEMA_VERSION:
            raise ValueError(
                f"Unsupported dataset recipe schema {self.schema_version!r}."
            )
        for name in ("recipe_id", "revision", "ontology_version"):
            if not getattr(self, name).strip():
                raise ValueError(f"Dataset recipe {name} must be non-empty.")
        seen: set[str] = set()
        for policy in self.corpora:
            policy.validate()
            if policy.corpus in seen:
                raise ValueError(f"Duplicate corpus recipe {policy.corpus!r}.")
            seen.add(policy.corpus)
        if not seen:
            raise ValueError("Dataset recipe must include at least one corpus.")

    def to_record(self) -> dict[str, object]:
        return {
            "schema_version": self.schema_version,
            "recipe_id": self.recipe_id,
            "revision": self.revision,
            "ontology_version": self.ontology_version,
            "corpora": [
                policy.to_record()
                for policy in sorted(self.corpora, key=lambda row: row.corpus)
            ],
        }

    @property
    def digest(self) -> str:
        """SHA-256 over the canonical record (reference ``recipe.py:118-123``)."""
        self.validate()
        payload = json.dumps(self.to_record(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def corpus_policy(self, corpus: str) -> CorpusRecipe | None:
        return next(
            (policy for policy in self.corpora if policy.corpus == corpus), None
        )


@dataclass(frozen=True)
class RoutedUtterance:
    """Exhaustive routing result for one manifest row."""

    utterance: Utterance
    disposition: str
    tasks: frozenset[str]
    reason: str


def _has_vad(utterance: Utterance) -> bool:
    """The VAD target exists only when all three coordinates are present
    (reference ``manifest.py:62-77``: VadTarget requires V, A, and D)."""
    return (
        utterance.valence is not None
        and utterance.arousal is not None
        and utterance.dominance is not None
    )


def route_utterance(utterance: Utterance, recipe: DatasetRecipe) -> RoutedUtterance:
    """Routes one row without forcing incompatible labels into the primary head.

    Reference semantics (``recipe.py:140-195``): every row gets the ``ssl``
    task; auxiliary tasks attach when both the target and the corpus policy
    allow them; the primary head only sees labels the policy marks exact (and
    whose RAW label is not flagged approximate); approximate labels survive as
    ``raw_emotion`` only; rows with no usable target are ``missing``; corpora
    outside the recipe quarantine.
    """
    policy = recipe.corpus_policy(utterance.corpus)
    if policy is None:
        return RoutedUtterance(utterance, "quarantined", frozenset(), "corpus_not_in_recipe")

    label = utterance.label
    tasks: set[str] = {"ssl"}
    if _has_vad(utterance) and "vad" in policy.auxiliary_tasks:
        tasks.add("vad")
    if (
        utterance.social_attitude is not None or label is not None
    ) and "attitude" in policy.auxiliary_tasks:
        tasks.add("attitude")
    if (
        utterance.binary_affect is not None or label is not None
    ) and "binary_affect" in policy.auxiliary_tasks:
        tasks.add("binary_affect")
    if utterance.language and "language" in policy.auxiliary_tasks:
        tasks.add("language")
    if utterance.transcript is not None and "text_alignment" in policy.auxiliary_tasks:
        tasks.add("text_alignment")

    raw_label = normalize_label(utterance.raw_label) if utterance.raw_label else label
    if (
        label is not None
        and label in policy.exact_primary_labels
        and raw_label not in policy.approximate_labels
    ):
        tasks.add("primary_emotion")
        disposition = "remapped" if raw_label != label else "accepted"
        return RoutedUtterance(utterance, disposition, frozenset(tasks), "exact_primary_label")
    if raw_label is not None and raw_label in policy.approximate_labels:
        tasks.add("raw_emotion")
        return RoutedUtterance(
            utterance, "weak", frozenset(tasks), "approximate_label_is_auxiliary_only"
        )
    if label is not None and "raw_emotion" in policy.auxiliary_tasks:
        tasks.add("raw_emotion")
    if len(tasks) > 1:
        return RoutedUtterance(utterance, "accepted", frozenset(tasks), "auxiliary_targets")
    if label is None and not any(
        (
            _has_vad(utterance),
            utterance.social_attitude is not None,
            utterance.binary_affect is not None,
            bool(utterance.language),
            utterance.transcript is not None,
        )
    ):
        return RoutedUtterance(utterance, "missing", frozenset(tasks), "no_usable_targets")
    return RoutedUtterance(
        utterance, "dropped", frozenset(tasks), "target_not_enabled_by_recipe"
    )


def research_recipe_v1() -> DatasetRecipe:
    """The leakage-safe cross-domain research recipe.

    Policy tables are parity constants (reference ``recipe.py:198-249``):
    nine corpora contribute exact canonical labels; EmoDB/EmoV-DB additionally
    flag their non-canonical moods approximate; escorpus-pe/att-hack/coraa-ser
    /pavoque are auxiliary-only.
    """
    exact_corpora = (
        "ravdess",
        "crema-d",
        "msp-podcast",
        "mesd",
        "oreau-french-esd",
        "cafe",
        "asvp-esd",
        "spanish-meacorpus-2023",
        "biic-podcast",
    )
    policies = [
        CorpusRecipe(corpus=corpus, exact_primary_labels=CANONICAL_EMOTIONS)
        for corpus in exact_corpora
    ]
    policies += [
        CorpusRecipe(
            corpus="escorpus-pe",
            approximate_labels=frozenset({"boredom", "neutral"}),
            auxiliary_tasks=("vad", "language"),
        ),
        CorpusRecipe(
            corpus="att-hack",
            auxiliary_tasks=("attitude", "language", "text_alignment"),
        ),
        CorpusRecipe(
            corpus="coraa-ser",
            auxiliary_tasks=("binary_affect", "language", "text_alignment"),
        ),
        CorpusRecipe(
            corpus="emodb-2.0",
            exact_primary_labels=CANONICAL_EMOTIONS,
            approximate_labels=frozenset({"boredom"}),
        ),
        CorpusRecipe(
            corpus="emov-db",
            exact_primary_labels=CANONICAL_EMOTIONS,
            approximate_labels=frozenset({"anxious", "amused", "sleepy"}),
        ),
        CorpusRecipe(corpus="pavoque", auxiliary_tasks=("raw_emotion", "language")),
        CorpusRecipe(corpus="jl-corpus", exact_primary_labels=CANONICAL_EMOTIONS),
    ]
    return DatasetRecipe(
        recipe_id="cross-domain-common",
        revision="1",
        ontology_version="canonical-eight-v1",
        corpora=tuple(policies),
    )


def load_dataset_recipe(value: str | Path) -> DatasetRecipe:
    """Loads a built-in recipe id or a versioned JSON recipe file
    (reference ``recipe.py:252-313``)."""
    if str(value) == "research-v1":
        return research_recipe_v1()
    path = Path(value).expanduser()
    try:
        payload = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as err:
        raise ValueError(f"Unable to load dataset recipe {path}: {err}") from err
    if not isinstance(payload, dict):
        raise ValueError("Dataset recipe root must be a JSON object.")
    corpora_raw = payload.get("corpora")
    if not isinstance(corpora_raw, list):
        raise ValueError("Dataset recipe 'corpora' must be a list.")
    corpora: list[CorpusRecipe] = []
    for raw in corpora_raw:
        if not isinstance(raw, dict):
            raise ValueError("Dataset recipe corpora must contain objects.")
        corpus = raw.get("corpus")
        if not isinstance(corpus, str) or not corpus.strip():
            raise ValueError("Dataset recipe corpus id must be non-empty.")
        lists: dict[str, list[str]] = {}
        for key in ("exact_primary_labels", "approximate_labels", "auxiliary_tasks"):
            items = raw.get(key, [])
            if not isinstance(items, list) or any(
                not isinstance(item, str) or not item.strip() for item in items
            ):
                raise ValueError(f"Dataset recipe {key!r} must be a list of strings.")
            lists[key] = items
        corpora.append(
            CorpusRecipe(
                corpus=corpus.strip(),
                exact_primary_labels=frozenset(
                    normalize_label(item) for item in lists["exact_primary_labels"]
                ),
                approximate_labels=frozenset(
                    normalize_label(item) for item in lists["approximate_labels"]
                ),
                auxiliary_tasks=tuple(
                    item.strip() for item in lists["auxiliary_tasks"]
                ),
            )
        )
    schema_version = payload.get("schema_version")
    recipe_id = payload.get("recipe_id")
    revision = payload.get("revision")
    ontology_version = payload.get("ontology_version")
    if (
        not isinstance(schema_version, int)
        or isinstance(schema_version, bool)
        or not isinstance(recipe_id, str)
        or not isinstance(revision, str)
        or not isinstance(ontology_version, str)
    ):
        raise ValueError(
            "Dataset recipe is missing required schema/id/revision/ontology fields."
        )
    recipe = DatasetRecipe(
        schema_version=schema_version,
        recipe_id=recipe_id,
        revision=revision,
        ontology_version=ontology_version,
        corpora=tuple(corpora),
    )
    recipe.validate()
    return recipe


#: Registered built-in recipe ids (the public knob is ``--dataset-recipe``).
RECIPES: dict[str, DatasetRecipe] = {"research-v1": research_recipe_v1()}


@dataclass(frozen=True)
class RecipeAuditIssue:
    """One recipe audit finding."""

    kind: str
    message: str
    blocking: bool


@dataclass(frozen=True)
class RecipeAuditReport:
    """All audit findings for one utterance set against one recipe."""

    recipe_id: str
    issues: tuple[RecipeAuditIssue, ...] = field(default_factory=tuple)

    @property
    def blocking(self) -> bool:
        return any(issue.blocking for issue in self.issues)


def get_recipe(recipe_id: str) -> DatasetRecipe:
    try:
        return RECIPES[recipe_id]
    except KeyError as err:
        raise KeyError(
            f"Unknown recipe {recipe_id!r}. Registered: {', '.join(sorted(RECIPES))}."
        ) from err


def audit_recipe(
    utterances: list[Utterance],
    recipe: DatasetRecipe,
    *,
    strict: bool = False,
    min_clips_per_class: int = MIN_CLIPS_PER_CLASS,
) -> RecipeAuditReport:
    """Findings-level audit: scope, routing losses, dedupe, leakage, floors.

    This is the readiness-gate view (warnings vs blockers); the ledger-level
    split assignment lives in :mod:`dataset_audit`. ``strict`` escalates
    missing digests/speakers and under-floor classes to blocking.
    """
    issues: list[RecipeAuditIssue] = []

    routed = [route_utterance(utterance, recipe) for utterance in utterances]
    unknown_corpora = sorted(
        {r.utterance.corpus for r in routed if r.reason == "corpus_not_in_recipe"}
    )
    if unknown_corpora:
        issues.append(
            RecipeAuditIssue(
                "corpus_scope",
                f"Corpora outside the recipe: {', '.join(unknown_corpora)}.",
                blocking=True,
            )
        )

    lost = Counter(
        r.disposition for r in routed if r.disposition in ("dropped", "missing", "weak")
    )
    if lost:
        detail = ", ".join(f"{k}={v}" for k, v in sorted(lost.items()))
        issues.append(
            RecipeAuditIssue(
                "routing_losses",
                f"Rows excluded from the primary head by routing: {detail}.",
                blocking=False,
            )
        )

    digests = [u.audio_sha256 for u in utterances if u.audio_sha256]
    duplicate_digests = [d for d, count in Counter(digests).items() if count > 1]
    if duplicate_digests:
        issues.append(
            RecipeAuditIssue(
                "duplicate_samples",
                f"{len(duplicate_digests)} duplicated audio digests across the set.",
                blocking=True,
            )
        )
    if len(digests) < len(utterances):
        issues.append(
            RecipeAuditIssue(
                "missing_digests",
                f"{len(utterances) - len(digests)} utterances lack audio_sha256 "
                "(dedupe incomplete).",
                blocking=strict,
            )
        )

    speaker_splits: dict[tuple[str, str], set[str]] = {}
    for u in utterances:
        if u.speaker_id and u.split:
            speaker_splits.setdefault((u.corpus, u.speaker_id), set()).add(u.split)
    leaking = [key for key, splits in speaker_splits.items() if len(splits) > 1]
    if leaking:
        issues.append(
            RecipeAuditIssue(
                "speaker_leakage",
                f"{len(leaking)} speakers appear in multiple splits "
                f"(e.g. {leaking[0][0]}/{leaking[0][1]}).",
                blocking=True,
            )
        )
    missing_speakers = sum(1 for u in utterances if not u.speaker_id)
    if missing_speakers:
        issues.append(
            RecipeAuditIssue(
                "missing_speaker_ids",
                f"{missing_speakers} utterances lack speaker ids.",
                blocking=strict,
            )
        )

    primary_counts = Counter(
        r.utterance.label for r in routed if "primary_emotion" in r.tasks
    )
    # The floor applies to the labels this recipe actually ROUTES, not all
    # eight canonical emotions: a narrower custom recipe (4-class) would
    # otherwise carry permanent blocking findings for classes it never
    # targets. A recipe with no declared exact labels keeps the full set.
    routable = frozenset().union(
        *(policy.exact_primary_labels for policy in recipe.corpora)
    ) or CANONICAL_EMOTIONS
    for label in sorted(routable):
        if primary_counts.get(label, 0) < min_clips_per_class:
            issues.append(
                RecipeAuditIssue(
                    "class_floor",
                    f"Class {label!r} has {primary_counts.get(label, 0)} routable "
                    f"clips (< {min_clips_per_class}).",
                    blocking=strict,
                )
            )

    return RecipeAuditReport(recipe_id=recipe.recipe_id, issues=tuple(issues))


__all__ = [
    "CANONICAL_EMOTIONS",
    "CorpusRecipe",
    "DATASET_RECIPE_SCHEMA_VERSION",
    "DatasetRecipe",
    "MIN_CLIPS_PER_CLASS",
    "RECIPES",
    "ROUTE_DISPOSITIONS",
    "RecipeAuditIssue",
    "RecipeAuditReport",
    "RoutedUtterance",
    "TASK_NAMES",
    "audit_recipe",
    "get_recipe",
    "load_dataset_recipe",
    "research_recipe_v1",
    "route_utterance",
]
