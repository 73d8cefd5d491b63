"""Deterministic temporal segment canonicalization.

Parity surface: reference ``ser/_internal/utils/segment_canonicalization.py``:
sorted, non-overlapping, positive-duration output where (1) same-label
adjacent/overlapping segments merge, (2) different-label overlaps truncate at
the newer start, and (3) same-start conflicts resolve by higher confidence then
lexical label order.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass
from typing import Protocol


class SegmentLike(Protocol):
    """Structural segment contract used for canonicalization."""

    @property
    def emotion(self) -> str: ...

    @property
    def start_seconds(self) -> float: ...

    @property
    def end_seconds(self) -> float: ...


@dataclass(frozen=True)
class CanonicalSegment:
    """Canonical non-overlapping segment record."""

    emotion: str
    start_seconds: float
    end_seconds: float


def _candidate(segment: SegmentLike) -> tuple[str, float, float, float | None] | None:
    """Validates one segment into (emotion, start, end, confidence) or None."""
    emotion = str(segment.emotion).strip()
    if not emotion:
        return None
    start, end = float(segment.start_seconds), float(segment.end_seconds)
    if not (math.isfinite(start) and math.isfinite(end)) or end <= start:
        return None
    confidence_raw = getattr(segment, "confidence", None)
    confidence: float | None = None
    if confidence_raw is not None:
        try:
            value = float(confidence_raw)
            confidence = value if math.isfinite(value) else None
        except (TypeError, ValueError):
            confidence = None
    return emotion, start, end, confidence


def _same_start_winner(group: list[tuple[str, float, float, float | None]]):
    """Picks the deterministic winner among candidates sharing a start time.

    Per-label reduction keeps the label's LONGEST candidate (strictly greater
    end replaces; ties keep the first seen), then the cross-label contest picks
    the highest confidence with lexical label order as the tiebreak — exactly
    the reference's semantics (segment_canonicalization.py:91-108), verified
    bitwise by tests/suites/parity/test_parity_timeline.py.
    """
    by_label: dict[str, tuple[str, float, float, float | None]] = {}
    for item in group:
        existing = by_label.get(item[0])
        if existing is None or item[2] > existing[2]:
            by_label[item[0]] = item
    return min(
        by_label.values(),
        key=lambda item: (-(item[3] if item[3] is not None else float("-inf")), item[0]),
    )


def canonicalize_segments(segments: Sequence[SegmentLike]) -> list[CanonicalSegment]:
    """Returns sorted, non-overlapping, positive-duration canonical segments."""
    validated = [c for c in (_candidate(s) for s in segments) if c is not None]
    if not validated:
        return []
    validated.sort(key=lambda item: (item[1], item[2]))

    selected: list[tuple[str, float, float, float | None]] = []
    index = 0
    while index < len(validated):
        stop = index + 1
        while stop < len(validated) and validated[stop][1] == validated[index][1]:
            stop += 1
        selected.append(_same_start_winner(validated[index:stop]))
        index = stop

    # [emotion, start, end] rows assembled under the non-overlap invariant.
    canonical: list[list] = []
    for emotion, start, end, _ in selected:
        if not canonical:
            canonical.append([emotion, start, end])
            continue
        previous = canonical[-1]
        if start < previous[2]:
            if emotion == previous[0]:
                previous[2] = max(previous[2], end)
                continue
            # Truncating to `start` can never empty `previous`: winners carry
            # strictly increasing starts, so start > previous[1] always (the
            # final positive-duration filter is the only guard needed).
            previous[2] = start
            canonical.append([emotion, start, end])
            continue
        if start == previous[2] and emotion == previous[0]:
            previous[2] = max(previous[2], end)
            continue
        canonical.append([emotion, start, end])

    return [
        CanonicalSegment(emotion=row[0], start_seconds=row[1], end_seconds=row[2])
        for row in canonical
        if row[2] > row[1]
    ]


__all__ = ["CanonicalSegment", "SegmentLike", "canonicalize_segments"]
