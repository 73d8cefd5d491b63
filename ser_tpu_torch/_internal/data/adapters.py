"""Per-dataset manifest adapters: filename conventions → utterances.

Counterpart of ``ser_tpu/_internal/data/adapters.py``: the same labels from the same file names.

Parity surface: reference ``ser/_internal/data/adapters/`` +
``strategies/default.py`` — each supported corpus with a parseable filename
convention gets a strategy that derives (label, speaker, extras) without a
labels CSV. CSV-labeled corpora go through the ``auto_csv`` path in
``prepare.py``.
"""

from __future__ import annotations

from pathlib import Path

from ser_tpu_torch._internal.data.manifest import Utterance

# CREMA-D: 1001_DFA_ANG_XX.wav → actor_sentence_emotion_level
_CREMA_EMOTIONS = {
    "ANG": "angry",
    "DIS": "disgust",
    "FEA": "fearful",
    "HAP": "happy",
    "NEU": "neutral",
    "SAD": "sad",
}

# EmoDB: 03a01Fa.wav → speaker(2) text(3) emotion(1) version(1)
_EMODB_EMOTIONS = {
    "W": "angry",       # Wut
    "L": "neutral",     # Langeweile/boredom → neutral, matching the reference
    #                     mapping (catalog/public_datasets.py:95) and the
    #                     token-inference path so both prepare routes agree.
    "E": "disgust",     # Ekel
    "A": "fearful",     # Angst
    "F": "happy",       # Freude
    "T": "sad",         # Trauer
    "N": "neutral",
}

# JL-Corpus: female1_angry_1a_1.wav → speaker_emotion_sentence_session
_JL_EMOTIONS = {
    "angry": "angry",
    "sad": "sad",
    "neutral": "neutral",
    "happy": "happy",
    "excited": "surprised",  # secondary → nearest primary class
    "anxious": "fearful",
}


def parse_crema_d(path: Path) -> Utterance | None:
    # Three underscore-separated fields suffice: actor_clip_code[_level]
    # (reference crema_d.py:146-159 parses code from parts[2] whenever at
    # least three parts exist; the intensity suffix is optional).
    parts = path.stem.split("_")
    if len(parts) < 3:
        return None
    # Code is taken verbatim (stripped, case-sensitive) and empty actors
    # become None — matching the reference extractors exactly
    # (crema_d.py:146-159).
    code = parts[2].strip()
    label = _CREMA_EMOTIONS.get(code)
    if label is None:
        return None
    return Utterance(
        sample_id=path.stem,
        corpus="crema-d",
        audio_path=str(path),
        label=label,
        raw_label=code,
        speaker_id=(f"crema-d:{parts[0].strip()}" if parts[0].strip() else None),
        language="en",
    )


def parse_emodb(path: Path) -> Utterance | None:
    stem = path.stem
    if len(stem) < 6:
        return None
    label = _EMODB_EMOTIONS.get(stem[5].upper())
    if label is None:
        return None
    return Utterance(
        sample_id=stem,
        corpus="emodb-2.0",
        audio_path=str(path),
        label=label,
        raw_label=stem[5].upper(),
        speaker_id=f"emodb-2.0:{stem[:2]}",
        language="de",
    )


def parse_jl_corpus(path: Path) -> Utterance | None:
    parts = path.stem.split("_")
    if len(parts) < 2:
        return None
    label = _JL_EMOTIONS.get(parts[1].lower())
    if label is None:
        return None
    return Utterance(
        sample_id=path.stem,
        corpus="jl-corpus",
        audio_path=str(path),
        label=label,
        raw_label=parts[1].lower(),
        speaker_id=f"jl-corpus:{parts[0]}",
        language="en",
    )


# The one manifest-building walk lives in strategies.DatasetStrategy.build;
# these parsers plug into it via strategies._wrap_adapter.
__all__ = ["parse_crema_d", "parse_emodb", "parse_jl_corpus"]
