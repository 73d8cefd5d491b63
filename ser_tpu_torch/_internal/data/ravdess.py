"""RAVDESS labels: the emotion codes and the file-name rule.

The port's own copies of ``RAVDESS_EMOTIONS``
(``ser_tpu/_internal/config/settings_builder.py``) and
``extract_ravdess_emotion_code`` (``ser_tpu/_internal/data/loader.py``).
"""

from __future__ import annotations

from collections.abc import Mapping
from types import MappingProxyType

RAVDESS_EMOTIONS: Mapping[str, str] = MappingProxyType(
    {
        "01": "neutral",
        "02": "calm",
        "03": "happy",
        "04": "sad",
        "05": "angry",
        "06": "fearful",
        "07": "disgust",
        "08": "surprised",
    }
)


def extract_ravdess_emotion_code(file_name: str) -> str | None:
    """RAVDESS filenames are 7 dash-separated codes; the third is the emotion."""
    parts = file_name.split("-")
    return parts[2] if len(parts) >= 3 else None


__all__ = ["RAVDESS_EMOTIONS", "extract_ravdess_emotion_code"]
