"""Per-dataset manifest strategies: every catalog corpus is prepare-able.

Counterpart of ``ser_tpu/_internal/data/strategies.py``: the same labels from the same trees.

Parity surface: reference ``ser/_internal/data/strategies/default.py`` +
``strategies/auto_csv.py`` + ``public_dataset_label_inference.py`` — a
registry mapping each of the 16 catalog dataset ids to a strategy that
derives utterances from a staged local tree. Resolution order per corpus
(reference auto-CSV semantics):

1. an explicit labels CSV, when the caller passes one;
2. a generated ``labels.csv`` at the dataset root (what the reference's
   download preparers emit);
3. corpus-native filename/path inference (token and code conventions below);
4. a typed error naming what is missing.

Label conventions are behavior parity with the reference's inference rules
(``public_dataset_label_inference.py:8-135``, per-corpus ``CsvManifestSpec``
mappings in ``catalog/public_datasets.py:27-295``), re-expressed here.
"""

from __future__ import annotations

import re
import unicodedata
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

from ser_tpu_torch._internal.data import adapters
from ser_tpu_torch._internal.data.manifest import Utterance

#: Reference ``DEFAULT_LABELS_FILE_NAME``.
GENERATED_LABELS_FILE = "labels.csv"

#: Multilingual token → primary-label map (en/es/fr/de synonyms across the
#: catalog corpora; the amused/sleepy entries carry EmoV-DB/PAVOQUE style
#: names, boredom carries EmoDB's).
_TOKEN_LABELS: dict[str, str] = {
    # angry
    "angry": "angry", "anger": "angry", "ira": "angry", "enojo": "angry",
    "enojado": "angry", "rabia": "angry", "colere": "angry", "furieux": "angry",
    "wut": "angry",
    # sad
    "sad": "sad", "sadness": "sad", "triste": "sad", "tristeza": "sad",
    "tristesse": "sad", "trauer": "sad",
    # happy
    "happy": "happy", "happiness": "happy", "joy": "happy", "feliz": "happy",
    "alegre": "happy", "alegria": "happy", "joie": "happy", "heureux": "happy",
    "freude": "happy", "amused": "happy",
    # fearful
    "fear": "fearful", "fearful": "fearful", "anxious": "fearful",
    "anxiety": "fearful", "miedo": "fearful", "temor": "fearful",
    "peur": "fearful", "angst": "fearful",
    # disgust
    "disgust": "disgust", "disgusted": "disgust", "asco": "disgust",
    "degout": "disgust", "ekel": "disgust",
    # surprised
    "surprise": "surprised", "surprised": "surprised", "sorpresa": "surprised",
    # neutral-family
    "neutral": "neutral", "neutro": "neutral", "neutre": "neutral",
    "calm": "neutral", "calme": "neutral", "boredom": "neutral",
    "sleepy": "neutral", "sleepiness": "neutral",
    # extended
    "contempt": "contempt", "desprecio": "contempt", "mepris": "contempt",
}

_ATT_HACK_ATTITUDES = frozenset({"friendly", "distant", "dominant", "seductive"})
_SPEAKER_TOKEN = re.compile(r"^(?:actor|speaker|spk|[fm]|male|female)?\d{1,4}[a-z]?$")
_VAD_SUFFIX = re.compile(r"-(\d{2})-(\d{2})-(\d{2})$")


def _normalize_tokens(path: Path) -> list[str]:
    """Lowercased, accent-stripped tokens from the stem + parent path parts."""
    pieces = [path.stem, *path.parent.parts]
    text = " ".join(piece.lower() for piece in pieces if piece)
    text = unicodedata.normalize("NFD", text)
    text = "".join(ch for ch in text if not unicodedata.combining(ch))
    return [token for token in re.split(r"[^a-z0-9]+", text) if token]


def _speaker_hint(path: Path) -> str | None:
    for token in _normalize_tokens(Path(path.name)):
        if _SPEAKER_TOKEN.match(token) and any(c.isdigit() for c in token):
            return token
    parent = path.parent.name
    return parent or None


def token_label(path: Path) -> tuple[str, str] | None:
    """(label, raw token) from path tokens against the multilingual map."""
    for token in _normalize_tokens(path):
        mapped = _TOKEN_LABELS.get(token)
        if mapped is not None:
            return mapped, token
    return None


def mesd_label(path: Path) -> tuple[str, str] | None:
    """MESD encodes the emotion as the first underscore-separated field."""
    first = path.stem.split("_", 1)[0].strip().lower()
    if first in ("anger", "disgust", "fear", "happiness", "neutral", "sadness"):
        return _TOKEN_LABELS[first], first
    return token_label(path)


def escorpus_pe_label(path: Path) -> tuple[str, str] | None:
    """ESCorpus-PE carries trailing -VV-AA-DD valence/arousal/dominance codes.

    The quadrant heuristic matches the reference's conservative mapping
    (``public_dataset_label_inference.py:80-100``).
    """
    match = _VAD_SUFFIX.search(path.stem)
    if match is None:
        return token_label(path)
    valence, arousal, dominance = (int(group) for group in match.groups())
    if valence >= 4 and arousal >= 4:
        label = "happy"
    elif valence <= 2 and arousal >= 4:
        label = "angry" if dominance >= 3 else "fearful"
    elif valence <= 2 and arousal <= 2:
        label = "sad"
    elif arousal >= 4 and valence == 3:
        label = "surprised"
    elif valence <= 2 and arousal == 3:
        label = "disgust"
    else:
        label = "neutral"
    return label, f"vad:{valence}-{arousal}-{dominance}"


def att_hack_label(path: Path) -> tuple[str, str] | None:
    """Att-HACK keeps its four social attitudes as corpus-native labels."""
    for token in _normalize_tokens(path):
        if token in _ATT_HACK_ATTITUDES:
            return token, token
    return None


def coraa_ser_label(path: Path) -> tuple[str, str] | None:
    """CORAA-SER's binary-plus-gender scheme (reference label mapping:
    neutral / non_neutral_female / non_neutral_male, ``public_datasets.py``).

    Labels resolve from the filename first, then from parent directories —
    staged trees group clips under label directories.
    """
    compact = re.sub(r"[^a-z]", "", str(path).lower())
    if "nonneutralfemale" in compact:
        return "non_neutral_female", "non_neutral_female"
    if "nonneutralmale" in compact:
        return "non_neutral_male", "non_neutral_male"
    if "neutral" in _normalize_tokens(path):
        return "neutral", "neutral"
    return None


def _wrap_adapter(parse: Callable[[Path], Utterance | None]):
    """Adapter → resolver, keeping the adapter's parsed speaker id.

    Filename adapters (CREMA-D actor field, EmoDB's leading speaker digits)
    know the corpus's real speaker convention; discarding it for the generic
    ``_speaker_hint`` collapsed e.g. every EmoDB utterance onto its parent
    directory name, silently breaking speaker-disjoint splits.
    """

    def resolver(path: Path) -> tuple[str, str, str | None] | None:
        utterance = parse(path)
        if utterance is None:
            return None
        return utterance.label, utterance.raw_label, utterance.speaker_id

    return resolver


@dataclass(frozen=True)
class DatasetStrategy:
    """How one corpus turns a staged tree into labeled utterances."""

    corpus_id: str
    language: str
    resolver: Callable[[Path], tuple[str, str] | None] | None
    audio_glob: str = "**/*.wav"
    csv_only_hint: str | None = None

    def build(self, root: Path, *, ontology=None) -> list[Utterance]:
        """Walks the staged tree into utterances.

        ``ontology`` (a ``data.ontology.LabelOntology``) optionally gates
        resolved labels through the reference's unknown-label policy
        (drop/error/map_to_other, reference ``ontology.py:33-66``); without
        one, resolver output is kept verbatim — the manifest schema's
        primary+extended label validation still applies downstream.
        """
        from ser_tpu_torch._internal.data.ontology import remap_label

        if self.resolver is None:
            raise ValueError(
                f"Dataset {self.corpus_id!r} has no filename convention"
                + (f" ({self.csv_only_hint})" if self.csv_only_hint else "")
                + f"; stage a {GENERATED_LABELS_FILE} at the dataset root or pass "
                "labels_csv_path."
            )
        utterances = []
        for path in sorted(root.glob(self.audio_glob)):
            # Resolve labels from the path RELATIVE to the corpus root: an
            # emotion word in an ancestor directory OUTSIDE the staged tree
            # (/srv/happy-lab/...) must never label the corpus.
            relative = path.relative_to(root)
            resolved = self.resolver(relative)
            if resolved is None:
                continue
            label, raw, *extra = resolved
            if ontology is not None:
                label = remap_label(raw_label=label, mapping=None, ontology=ontology)
                if label is None:
                    continue
            speaker = extra[0] if extra else None
            if speaker is None:
                speaker = _speaker_hint(relative)
            # Corpus-scoped speaker ids (reference adapters, e.g.
            # ravdess.py:87, csv_manifest_builder.py:150) — manifest
            # validation enforces the prefix to prevent cross-corpus
            # speaker-id collisions in grouped splits. Adapters that
            # already scope their ids pass through unchanged.
            if speaker is not None and not speaker.startswith(f"{self.corpus_id}:"):
                speaker = f"{self.corpus_id}:{speaker}"
            utterances.append(
                Utterance(
                    sample_id=path.stem,
                    corpus=self.corpus_id,
                    audio_path=str(path),
                    label=label,
                    raw_label=raw,
                    speaker_id=speaker,
                    language=self.language,
                )
            )
        return utterances


STRATEGIES: dict[str, DatasetStrategy] = {
    spec.corpus_id: spec
    for spec in (
        DatasetStrategy("crema-d", "en", _wrap_adapter(adapters.parse_crema_d)),
        DatasetStrategy("emodb-2.0", "de", _wrap_adapter(adapters.parse_emodb)),
        DatasetStrategy("jl-corpus", "en", _wrap_adapter(adapters.parse_jl_corpus)),
        DatasetStrategy("mesd", "es", mesd_label),
        DatasetStrategy("escorpus-pe", "es", escorpus_pe_label),
        DatasetStrategy("spanish-meacorpus-2023", "es", token_label),
        DatasetStrategy("cafe", "fr", token_label),
        DatasetStrategy("oreau-french-esd", "fr", token_label),
        DatasetStrategy("att-hack", "fr", att_hack_label),
        DatasetStrategy("asvp-esd", "mixed", token_label),
        DatasetStrategy("emov-db", "en", token_label),
        DatasetStrategy("pavoque", "de", token_label),
        DatasetStrategy("coraa-ser", "pt", coraa_ser_label),
        DatasetStrategy(
            "msp-podcast",
            "en",
            None,
            csv_only_hint="labels ship as annotation CSVs, not filenames",
        ),
        DatasetStrategy(
            "biic-podcast",
            "zh",
            None,
            csv_only_hint="labels ship as annotation CSVs, not filenames",
        ),
    )
}
# ravdess routes through prepare._build_ravdess_manifest (settings-owned
# code→emotion map); listed here so every catalog id resolves.
STRATEGY_IDS: tuple[str, ...] = tuple(sorted({*STRATEGIES, "ravdess"}))


def get_strategy(dataset_id: str) -> DatasetStrategy:
    if dataset_id == "ravdess":
        raise KeyError(
            "ravdess routes through the built-in RAVDESS preparer "
            "(prepare.prepare_dataset applies the settings-owned code→emotion "
            "map); it has no generic strategy."
        )
    try:
        return STRATEGIES[dataset_id]
    except KeyError as err:
        known = ", ".join(sorted(STRATEGIES))
        raise KeyError(
            f"No dataset strategy for {dataset_id!r}; known: {known}."
        ) from err


__all__ = [
    "GENERATED_LABELS_FILE",
    "STRATEGIES",
    "STRATEGY_IDS",
    "DatasetStrategy",
    "att_hack_label",
    "coraa_ser_label",
    "escorpus_pe_label",
    "get_strategy",
    "mesd_label",
    "token_label",
]
