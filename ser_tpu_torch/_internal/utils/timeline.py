"""Merge, render and persist transcript-emotion timelines.

Copied from ``ser_tpu/_internal/utils/timeline.py``: millisecond-resolution
joins, the O(T+E) active-emotion lookup, CSV export with 2-decimal
timestamps (byte-equal to the JAX package's), and the colorized table.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path

from ser_tpu_torch._internal.config.schema import TimelineConfig
from ser_tpu_torch._internal.utils.common import display_elapsed_time
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.segment_canonicalization import canonicalize_segments
from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord

logger = get_logger(__name__)

_ANSI_FG = {"black": 30}
_ANSI_BG = {"green": 42, "yellow": 43, "blue": 44}


def _to_milliseconds(seconds: float) -> int:
    """Converts seconds to integer milliseconds for stable timeline joins."""
    return int(round(seconds * 1000))


def _emotion_lookup(
    timestamps_ms: list[int], emotion_segments: list[tuple[str, int, int]]
) -> dict[int, str]:
    """O(T + E) lookup of the active emotion at each timeline timestamp."""
    if not timestamps_ms or not emotion_segments:
        return {}
    lookup: dict[int, str] = {}
    segment_idx = 0
    last_emotion, _, last_end_ms = emotion_segments[-1]
    for timestamp_ms in timestamps_ms:
        while segment_idx < len(emotion_segments):
            _, _, current_end = emotion_segments[segment_idx]
            if timestamp_ms < current_end:
                break
            segment_idx += 1
        if segment_idx < len(emotion_segments):
            emotion, start_ms, end_ms = emotion_segments[segment_idx]
            if start_ms <= timestamp_ms < end_ms:
                lookup[timestamp_ms] = emotion
        elif timestamp_ms == last_end_ms:
            lookup[timestamp_ms] = last_emotion
    return lookup


def build_timeline(
    text_with_timestamps: list[TranscriptWord],
    emotion_with_timestamps: list[EmotionSegment],
) -> list[TimelineEntry]:
    """Merges transcript and emotion streams into one timeline keyed on starts."""
    if not text_with_timestamps and not emotion_with_timestamps:
        return []

    words_by_timestamp: dict[int, list[str]] = defaultdict(list)
    for word in sorted(text_with_timestamps, key=lambda item: item.start_seconds):
        words_by_timestamp[_to_milliseconds(float(word.start_seconds))].append(word.word.strip())

    emotion_segments: list[tuple[str, int, int]] = []
    for segment in canonicalize_segments(emotion_with_timestamps):
        start_ms = _to_milliseconds(float(segment.start_seconds))
        end_ms = _to_milliseconds(float(segment.end_seconds))
        if end_ms <= start_ms:
            end_ms = start_ms + 1
        emotion_segments.append((segment.emotion, start_ms, end_ms))

    terminal_timestamps = {emotion_segments[-1][2]} if emotion_segments else set()
    all_timestamps = sorted(
        set(words_by_timestamp)
        | {start for _, start, _ in emotion_segments}
        | terminal_timestamps
    )

    lookup = _emotion_lookup(all_timestamps, emotion_segments)
    return [
        TimelineEntry(
            timestamp_seconds=timestamp_ms / 1000.0,
            emotion=lookup.get(timestamp_ms, ""),
            speech=" ".join(words_by_timestamp.get(timestamp_ms, [])).strip(),
        )
        for timestamp_ms in all_timestamps
    ]


def save_timeline_to_csv(
    timeline: list[TimelineEntry],
    file_name: str,
    *,
    timeline_config: TimelineConfig | None = None,
) -> str:
    """Saves timeline rows as CSV under the configured transcript folder."""
    config = timeline_config if timeline_config is not None else TimelineConfig()
    config.folder.mkdir(parents=True, exist_ok=True)
    output_path = config.folder / f"{Path(file_name).stem}.csv"
    with open(output_path, mode="w", newline="", encoding="utf-8") as handle:
        writer = csv.writer(handle)
        writer.writerow(["Time (s)", "Emotion", "Speech"])
        for entry in timeline:
            writer.writerow([round(float(entry.timestamp_seconds), 2), entry.emotion, entry.speech])
    logger.info("Timeline saved to %s", output_path)
    return str(output_path)


def color_txt(string: str, fg_color: str, bg_color: str, padding: int = 0) -> str:
    """Applies foreground/background ANSI colors to terminal text."""
    if padding:
        string = string.ljust(padding)
    fg = _ANSI_FG.get(fg_color, 37)
    bg = _ANSI_BG.get(bg_color, 40)
    return f"\x1b[{fg}m\x1b[{bg}m{string}\x1b[0m"


def print_timeline(timeline: list[TimelineEntry]) -> None:
    """Prints the timeline as a colorized table."""
    if not timeline:
        print("No timeline data available.")
        return

    time_width = max(
        len("Time"),
        *(len(display_elapsed_time(float(e.timestamp_seconds), _format="short")) for e in timeline),
    )
    emotion_width = max(len("Emotion"), *(len(e.emotion.capitalize()) for e in timeline))
    speech_width = max(len("Speech"), *(len(e.speech.strip()) for e in timeline))

    # Headers carry the same single-space separators as the data rows, so
    # the colorized columns line up.
    print(color_txt("Time", "black", "green", time_width), end=" ")
    print(color_txt("Emotion", "black", "yellow", emotion_width), end=" ")
    print(color_txt("Speech", "black", "blue", speech_width))
    for entry in timeline:
        time_str = display_elapsed_time(float(entry.timestamp_seconds), _format="short")
        print(
            f"{time_str.ljust(time_width)} "
            f"{entry.emotion.capitalize().ljust(emotion_width)} "
            f"{entry.speech.strip().ljust(speech_width)}"
        )


__all__ = ["build_timeline", "color_txt", "print_timeline", "save_timeline_to_csv"]
