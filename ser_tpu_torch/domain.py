"""Domain data structures for transcript, emotion, and timeline entities.

Parity surface: reference ``ser/domain.py:8-37`` — identical NamedTuple field
names and ordering so downstream consumers (timeline joins, CSV export,
subtitle rendering) behave the same.
"""

from typing import NamedTuple

__all__ = ["DatasetConsents", "EmotionSegment", "TimelineEntry", "TranscriptWord"]


class DatasetConsents(NamedTuple):
    """Persisted dataset policy and license consent identifiers."""

    policy_ids: tuple[str, ...]
    license_ids: tuple[str, ...]


class TranscriptWord(NamedTuple):
    """A transcript word with start/end timing in seconds."""

    word: str
    start_seconds: float
    end_seconds: float


class EmotionSegment(NamedTuple):
    """An emotion label active over a time interval."""

    emotion: str
    start_seconds: float
    end_seconds: float


class TimelineEntry(NamedTuple):
    """A merged timeline row containing time, emotion, and speech text."""

    timestamp_seconds: float
    emotion: str
    speech: str
