"""Subtitle export (ASS/SRT/VTT) from timeline rows.

Copied from ``ser_tpu/_internal/utils/subtitles.py``: the same export-request
resolution (an explicit format wins, else the output path's suffix), the
same cues (speech rows only, each ending at the next row or after a 1 s
default), captions ``text (emotion)``, and each container's timestamps. The
files are byte-equal to the JAX package's, the ASS header included.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Literal, cast

from ser_tpu_torch._internal.config.schema import TimelineConfig
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.domain import TimelineEntry

logger = get_logger(__name__)

type SubtitleFormat = Literal["ass", "srt", "vtt"]
SUPPORTED_SUBTITLE_FORMATS: tuple[SubtitleFormat, ...] = ("ass", "srt", "vtt")
DEFAULT_SUBTITLE_DURATION_SECONDS = 1.0

# Byte-exact output contract: the JAX package's ASS header, so exported .ass
# files stay interchangeable between the packages.
_ASS_HEADER = """[Script Info]
Title: SER Timeline Export
ScriptType: v4.00+
Collisions: Normal
PlayDepth: 0

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding
Style: Default,Arial,20,&H00FFFFFF,&H000000FF,&H00000000,&H64000000,-1,0,0,0,100,100,0,0.00,1,1.00,0.00,2,10,10,10,1

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
"""


@dataclass(frozen=True, slots=True)
class SubtitleCue:
    """One rendered subtitle cue."""

    start_seconds: float
    end_seconds: float
    text: str
    emotion: str


def infer_subtitle_format(output_path: str) -> SubtitleFormat | None:
    """Infers subtitle format from an output-path suffix."""
    suffix = Path(output_path).suffix.lower().lstrip(".")
    if suffix in SUPPORTED_SUBTITLE_FORMATS:
        return cast(SubtitleFormat, suffix)
    return None


def resolve_subtitle_export_request(
    *,
    output_path: str | None,
    subtitle_format: SubtitleFormat | None,
) -> tuple[SubtitleFormat, str | None] | None:
    """Resolves (format, path) for a requested export; None when not requested.

    Resolution contract (reference ``subtitles.py:101-199`` semantics): an
    explicit format wins; otherwise the format comes from the output path's
    suffix; neither present means no export was asked for.
    """
    path = output_path.strip() if output_path is not None else None
    if path == "":
        raise ValueError("A subtitle output path was given but is blank.")
    if subtitle_format is not None and subtitle_format not in SUPPORTED_SUBTITLE_FORMATS:
        supported = ", ".join(SUPPORTED_SUBTITLE_FORMATS)
        raise ValueError(
            f"Subtitle format {subtitle_format!r} is not supported (choose {supported})."
        )

    resolved = subtitle_format
    if resolved is None and path is not None:
        resolved = infer_subtitle_format(path)
        if resolved is None:
            supported = ", ".join(f".{fmt}" for fmt in SUPPORTED_SUBTITLE_FORMATS)
            raise ValueError(
                f"Cannot infer a subtitle format from {path!r}: pass "
                f"--subtitle-format or use a {supported} suffix."
            )
    if resolved is None:
        return None
    return resolved, path


def timeline_to_subtitle_cues(
    timeline: list[TimelineEntry],
    *,
    default_duration_seconds: float = DEFAULT_SUBTITLE_DURATION_SECONDS,
) -> list[SubtitleCue]:
    """Builds subtitle cues from timeline rows carrying speech content.

    Cue timing contract: each speech row runs until the NEXT timeline row
    (whatever its content), falling back to a fixed default duration when no
    later row exists or timestamps do not advance.
    """
    if default_duration_seconds <= 0.0:
        raise ValueError(f"Cue default duration must be positive, got {default_duration_seconds}.")
    ordered = sorted(timeline, key=lambda entry: float(entry.timestamp_seconds))
    boundaries = [float(entry.timestamp_seconds) for entry in ordered[1:]] + [None]
    cues: list[SubtitleCue] = []
    for entry, boundary in zip(ordered, boundaries):
        text = entry.speech.strip()
        if not text:
            continue
        start = float(entry.timestamp_seconds)
        end = boundary if boundary is not None and boundary > start else start + default_duration_seconds
        cues.append(
            SubtitleCue(start_seconds=start, end_seconds=end, text=text, emotion=entry.emotion)
        )
    return cues


def save_timeline_to_subtitles(
    timeline: list[TimelineEntry],
    file_name: str,
    *,
    subtitle_format: SubtitleFormat,
    output_path: str | None = None,
    timeline_config: TimelineConfig | None = None,
) -> str:
    """Writes timeline subtitles and returns the generated artifact path."""
    cues = timeline_to_subtitle_cues(timeline)
    config = timeline_config if timeline_config is not None else TimelineConfig()
    target = (
        Path(output_path)
        if isinstance(output_path, str) and output_path
        else config.folder / f"{Path(file_name).stem}.{subtitle_format}"
    )
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(_render(cues, subtitle_format), encoding="utf-8")
    logger.info("Timeline subtitles saved to %s", target)
    return str(target)


def _caption(cue: SubtitleCue) -> str:
    text = cue.text.replace("\r", " ").replace("\n", " ").strip()
    emotion = cue.emotion.strip()
    return f"{text} ({emotion})" if emotion else text


def _ass_time(seconds: float) -> str:
    centis = max(int(round(seconds * 100)), 0)
    hours, rem = divmod(centis, 360000)
    minutes, rem = divmod(rem, 6000)
    secs, cs = divmod(rem, 100)
    return f"{hours}:{minutes:02d}:{secs:02d}.{cs:02d}"


def _ms_time(seconds: float, separator: str) -> str:
    millis = max(int(round(seconds * 1000)), 0)
    hours, rem = divmod(millis, 3_600_000)
    minutes, rem = divmod(rem, 60_000)
    secs, ms = divmod(rem, 1000)
    return f"{hours:02d}:{minutes:02d}:{secs:02d}{separator}{ms:03d}"


def _render(cues: list[SubtitleCue], subtitle_format: SubtitleFormat) -> str:
    if subtitle_format == "ass":
        body = "\n".join(
            "Dialogue: 0,"
            f"{_ass_time(cue.start_seconds)},{_ass_time(cue.end_seconds)},"
            f"Default,,0,0,0,,{_caption(cue)}"
            for cue in cues
        )
        return f"{_ASS_HEADER}{body}\n" if body else _ASS_HEADER
    if subtitle_format == "srt":
        body = "\n".join(
            f"{index}\n"
            f"{_ms_time(cue.start_seconds, ',')} --> {_ms_time(cue.end_seconds, ',')}\n"
            f"{_caption(cue)}\n"
            for index, cue in enumerate(cues, start=1)
        )
        return f"{body}\n" if body else ""
    if subtitle_format == "vtt":
        body = "\n".join(
            f"{_ms_time(cue.start_seconds, '.')} --> {_ms_time(cue.end_seconds, '.')}\n"
            f"{_caption(cue)}\n"
            for cue in cues
        )
        return f"WEBVTT\n\n{body}\n" if body else "WEBVTT\n"
    raise ValueError(f"Unsupported subtitle format: {subtitle_format}")


__all__ = [
    "DEFAULT_SUBTITLE_DURATION_SECONDS",
    "SUPPORTED_SUBTITLE_FORMATS",
    "SubtitleCue",
    "SubtitleFormat",
    "infer_subtitle_format",
    "resolve_subtitle_export_request",
    "save_timeline_to_subtitles",
    "timeline_to_subtitle_cues",
]
