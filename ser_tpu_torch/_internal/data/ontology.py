"""Label ontologies: the canonical label space and what becomes of labels outside it.

Counterpart of ``ser_tpu/_internal/data/ontology.py``: ``LabelOntology``,
``normalize_label`` (stripped, lower case), ``remap_label`` with its
``drop`` / ``error`` / ``map_to_other`` policies, and
``resolve_label_ontology``, which reads the settings snapshot
(``SER_LABEL_ONTOLOGY_ID``, ``SER_ALLOWED_LABELS``,
``SER_UNKNOWN_LABEL_POLICY``, ``SER_OTHER_LABEL``), never ``os.environ``.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Literal

type UnknownLabelPolicy = Literal["drop", "error", "map_to_other"]

_POLICIES: frozenset[str] = frozenset({"drop", "error", "map_to_other"})


@dataclass(frozen=True)
class LabelOntology:
    """The canonical label space plus the unknown-label disposition."""

    ontology_id: str
    allowed_labels: frozenset[str]
    unknown_label_policy: UnknownLabelPolicy = "drop"
    other_label: str = "other"


def normalize_label(label: str) -> str:
    """Canonical label form: stripped, lowercase."""
    return label.strip().lower()


def ensure_label_allowed(*, label: str, ontology: LabelOntology) -> None:
    """Raises ``ValueError`` when ``label`` is outside the ontology."""
    if label not in ontology.allowed_labels:
        raise ValueError(
            f"Label {label!r} is not part of ontology {ontology.ontology_id!r}."
        )


def remap_label(
    *,
    raw_label: str,
    mapping: Mapping[str, str] | None,
    ontology: LabelOntology,
) -> str | None:
    """Raw dataset label → canonical label under the ontology's policy.

    A mapped-and-allowed label passes through normalized; anything else is
    dispatched on ``unknown_label_policy``: dropped (``None``), mapped onto
    ``other_label`` (which must itself be allowed), or raised as ``ValueError``
    (reference ``ontology.py:33-66``).
    """
    mapped = mapping.get(raw_label.strip(), "") if mapping is not None else raw_label
    canonical = normalize_label(mapped) if mapped else ""
    if canonical and canonical in ontology.allowed_labels:
        return canonical

    policy = ontology.unknown_label_policy
    if policy == "drop":
        return None
    if policy == "map_to_other":
        other = normalize_label(ontology.other_label)
        ensure_label_allowed(label=other, ontology=ontology)
        return other
    raise ValueError(
        f"Unknown label {raw_label!r} under ontology {ontology.ontology_id!r}."
    )


def resolve_label_ontology(settings) -> LabelOntology:
    """Builds the active ontology from one settings snapshot.

    Allowed labels default to the configured emotion map's values; the
    ``SER_ALLOWED_LABELS`` capture overrides them wholesale
    (reference ``label_ontology.py:20-44``).
    """
    config = settings.ontology
    if config.allowed_labels:
        allowed = {
            normalize_label(item) for item in config.allowed_labels if item.strip()
        }
    else:
        allowed = {normalize_label(label) for label in settings.emotions.values()}
    if not allowed:
        raise RuntimeError(
            "Resolved SER label ontology contains zero allowed labels. "
            "Check SER_ALLOWED_LABELS / configured emotion mapping."
        )
    return LabelOntology(
        ontology_id=config.ontology_id,
        allowed_labels=frozenset(allowed),
        unknown_label_policy=config.unknown_label_policy,
        other_label=normalize_label(config.other_label),
    )


__all__ = [
    "LabelOntology",
    "UnknownLabelPolicy",
    "ensure_label_allowed",
    "normalize_label",
    "remap_label",
    "resolve_label_ontology",
]
