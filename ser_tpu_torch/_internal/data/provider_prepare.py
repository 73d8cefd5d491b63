"""Per-dataset acquisition workflows: download → extract → labels.csv.

Counterpart of ``ser_tpu/_internal/data/provider_prepare.py``: the same workflows and the same ``labels.csv`` files.

Parity surface: reference ``ser/_internal/data/public_dataset_downloads.py``
(pinned record ids/keys, per-dataset orchestration), ``zenodo_downloads.py``
(record-file download, metadata-CSV label generation),
``openslr_downloads.py:179-261`` (pinned-mirror → HF-script → listing-HTML
resolution ladder), ``mendeley_downloads.py:125-168`` (folder-tree walk),
``provider_dataset_preparation.py`` (labels/source-manifest artifacts), and
``jl_corpus_downloads.py`` (Kaggle → HF-rows fallback).

Design: each ``prepare_<dataset>`` function is a plain sequential workflow over
an injected :class:`~provider_transport.ProviderTransport` and overridable API
bases — the complete acquisition pipeline runs against ``file://`` fixtures
with zero egress, and against the live providers unchanged. Network failures
surface as :class:`~downloads.DatasetDownloadUnavailableError` with the
staging hint, keeping this runtime's stage-locally contract intact.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import subprocess
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

from ser_tpu_torch._internal.data import provider_resolution as resolution
from ser_tpu_torch._internal.data import strategies
from ser_tpu_torch._internal.data.downloads import (
    DatasetDownloadUnavailableError,
    extract_archive,
)
from ser_tpu_torch._internal.data.provider_transport import (
    DEFAULT_TRANSPORT,
    ProviderTransport,
    TransportError,
)
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

LABELS_FILE_NAME = "labels.csv"


def _contained_destination(root: Path, *parts: object) -> Path:
    """Joins remote-controlled path parts under ``root``, traversal-safe.

    Provider payloads carry file names chosen by the uploader (Mendeley
    ``meta.key``, GitHub release ``asset.key``); a name like
    ``../../home/user/.bashrc`` must not escape the dataset root — the same
    containment rule archive extraction enforces via ``_safe_members``.
    """
    candidate = root.joinpath(*(str(part) for part in parts))
    root_resolved = root.resolve()
    resolved = candidate.resolve()
    if resolved != root_resolved and root_resolved not in resolved.parents:
        raise TransportError(
            f"Provider-supplied file name escapes the dataset root: {candidate}"
        )
    return candidate
SOURCE_MANIFEST_FILE_NAME = "source_manifest.json"

# Pinned provider coordinates (reference `public_dataset_downloads.py:56-100`).
RAVDESS_ZENODO = ("1188976", "Audio_Speech_Actors_01-24.zip")
EMODB_2_ZENODO = ("17651657", "emodb_2.0.zip")
ESCORPUS_PE_ZENODO = ("5793223", "Corpus_Globalv1.zip")
OREAU_ZENODO = ("4405783", ("OréauFR_01.rar", "OréauFR_02.rar"), "Doc_FR.rar")
CAFE_ZENODO = ("1478765", ("CaFE_192k_1.zip", "CaFE_192k_2.zip"))
ASVP_ESD_ZENODO = ("7132783", "ASVP-ESD-Update.zip")
MEACORPUS_ZENODO = ("18606423", "spanish-meacorpus-2023-dataset.csv")
MESD_MENDELEY = ("cy34mh68j9", 5)
EMOV_DB_OPENSLR = ("115", (".tar.gz", ".tgz"))
ATT_HACK_OPENSLR = ("88", (".tgz",))
PAVOQUE_GITHUB = ("marytts", "pavoque-data")
JL_CORPUS_KAGGLE_REF = "tli725/jl-corpus"
JL_CORPUS_HF = ("CLAPv2/JL-Corpus", "default", "train", 100)
JL_CORPUS_HF_ROWS_API = "https://datasets-server.huggingface.co/rows"
CREMA_D_GIT = "https://github.com/CheyneyComputerScience/CREMA-D.git"
CORAA_SER_GDRIVE_FOLDER = (
    "https://drive.google.com/drive/folders/12Nuv8J7pBHJuNU3nH2c7F8VwCDEE6GDt"
)

#: EmoDB's German-corpus label names → primary labels (reference
#: ``public_dataset_downloads.py:225-233``).
EMODB_LABEL_MAP: dict[str, str] = {
    "anger": "angry",
    "boredom": "neutral",
    "disgust": "disgust",
    "fear": "fearful",
    "happiness": "happy",
    "neutral": "neutral",
    "sadness": "sad",
}

#: Spanish MEACorpus metadata labels (reference ``zenodo_downloads.py:624-631``).
MEACORPUS_LABEL_MAP: dict[str, str] = {
    "anger": "angry",
    "disgust": "disgust",
    "fear": "fearful",
    "joy": "happy",
    "neutral": "neutral",
    "sadness": "sad",
}


@dataclass(frozen=True)
class GeneratedLabelsStats:
    """Outcome counters for one labels.csv generation pass."""

    files_seen: int
    labels_written: int
    dropped_files: int
    duplicate_conflicts: int


@dataclass(frozen=True)
class AutoDownloadArtifacts:
    """What one acquisition produced: roots, labels, and provenance."""

    dataset_root: Path
    labels_csv_path: Path | None
    audio_base_dir: Path | None
    source_manifest_path: Path
    files_seen: int
    labels_written: int


# --------------------------------------------------------------------------- #
# Shared artifact writers
# --------------------------------------------------------------------------- #


def write_labels_csv(labels_csv_path: Path, labels_by_file: dict[str, str]) -> None:
    """Deterministic, atomic ``FileName,emotion`` CSV (reference format)."""
    labels_csv_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = labels_csv_path.with_suffix(labels_csv_path.suffix + ".tmp")
    with tmp.open("w", encoding="utf-8", newline="") as handle:
        writer = csv.DictWriter(handle, fieldnames=["FileName", "emotion"])
        writer.writeheader()
        for file_name in sorted(labels_by_file):
            writer.writerow({"FileName": file_name, "emotion": labels_by_file[file_name]})
    os.replace(tmp, labels_csv_path)


def write_source_manifest(
    *,
    dataset_root: Path,
    source_manifest_path: Path,
    source_payload: dict[str, object],
    labels_csv_path: Path | None,
    labels_stats: GeneratedLabelsStats | None,
) -> None:
    """Provenance record: where the data came from and what was generated."""
    payload: dict[str, object] = {"source": source_payload}
    if labels_csv_path is not None:
        try:
            payload["labels_csv"] = str(labels_csv_path.relative_to(dataset_root))
        except ValueError:
            payload["labels_csv"] = str(labels_csv_path)
    if labels_stats is not None:
        payload["labels_stats"] = {
            "files_seen": labels_stats.files_seen,
            "labels_written": labels_stats.labels_written,
            "dropped_files": labels_stats.dropped_files,
            "duplicate_conflicts": labels_stats.duplicate_conflicts,
        }
    source_manifest_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = source_manifest_path.with_suffix(source_manifest_path.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2, sort_keys=True), encoding="utf-8")
    os.replace(tmp, source_manifest_path)


def ensure_extracted_archive(archive_path: Path, extract_root: Path) -> None:
    """Extracts one archive at most once, keyed by a per-archive marker file.

    zip/tar route through :func:`downloads.extract_archive` (traversal-safe);
    ``.rar`` shells out to the first available extractor, matching the
    reference's backend ladder (``archive_extraction.py``).
    """
    marker = extract_root / f".extract-ok-{archive_path.name}.json"
    if marker.is_file():
        return
    extract_root.mkdir(parents=True, exist_ok=True)
    if archive_path.suffix.lower() == ".rar":
        members = _extract_rar(archive_path, extract_root)
    else:
        members = len(extract_archive(archive_path, extract_root))
    marker.write_text(
        json.dumps({"archive": archive_path.name, "members": members}), encoding="utf-8"
    )


def _extract_rar(archive_path: Path, extract_root: Path) -> int:
    for command in (
        ["unar", "-force-overwrite", "-o", str(extract_root), str(archive_path)],
        ["bsdtar", "-x", "-f", str(archive_path), "-C", str(extract_root)],
        ["unrar", "x", "-o+", str(archive_path), f"{extract_root}{os.sep}"],
    ):
        binary = shutil.which(command[0])
        if binary is None:
            continue
        completed = subprocess.run(  # noqa: S603 - fixed argv, no shell
            [binary, *command[1:]], capture_output=True, text=True, check=False
        )
        if completed.returncode == 0:
            return sum(1 for p in extract_root.rglob("*") if p.is_file())
        raise RuntimeError(
            f"{command[0]} failed extracting {archive_path.name}: {completed.stderr.strip()}"
        )
    raise RuntimeError(
        f"No RAR extractor available for {archive_path.name}; install unar, bsdtar, or unrar."
    )


def _relative_to_root(dataset_root: Path, path: Path) -> str:
    return path.resolve().relative_to(dataset_root.resolve()).as_posix()


def generate_labels_from_audio_tree(
    *,
    dataset_root: Path,
    search_root: Path,
    labels_csv_path: Path,
    resolver: Callable[[Path], str | None],
    extensions: frozenset[str] = frozenset({".wav"}),
) -> GeneratedLabelsStats:
    """Walks audio files, resolves labels from paths, writes labels.csv."""
    files_seen = 0
    dropped = 0
    labels_by_file: dict[str, str] = {}
    normalized = frozenset(ext.lower() for ext in extensions)
    for path in sorted(search_root.rglob("*")):
        if not path.is_file() or path.suffix.lower() not in normalized:
            continue
        files_seen += 1
        label = resolver(path)
        if label is None:
            dropped += 1
            continue
        labels_by_file[_relative_to_root(dataset_root, path)] = label
    write_labels_csv(labels_csv_path, labels_by_file)
    return GeneratedLabelsStats(files_seen, len(labels_by_file), dropped, 0)


def generate_labels_from_metadata_csv(
    *,
    dataset_root: Path,
    metadata_csv_path: Path,
    labels_csv_path: Path,
    audio_search_roots: tuple[Path, ...],
    file_name_keys: tuple[str, ...],
    label_keys: tuple[str, ...],
    label_resolver: Callable[[str], str | None],
    normalize_file_name: Callable[[str], str] | None = None,
) -> GeneratedLabelsStats:
    """Metadata-CSV → labels.csv, keeping only rows whose audio exists locally.

    Matches the reference's row semantics (``zenodo_downloads.py:199-283``):
    first non-empty file/label key wins, unresolvable labels drop, a direct
    path under each search root is tried before an rglob basename fallback,
    and duplicate relative paths count as conflicts when the labels differ.
    """
    rows_seen = 0
    dropped = 0
    conflicts = 0
    labels_by_file: dict[str, str] = {}
    roots = tuple(root.expanduser().resolve() for root in audio_search_roots)

    with metadata_csv_path.open("r", encoding="utf-8", newline="") as handle:
        for row in csv.DictReader(handle):
            rows_seen += 1
            file_name = next(
                (str(row[k]).strip() for k in file_name_keys if isinstance(row.get(k), str) and row[k].strip()),
                "",
            )
            raw_label = next(
                (str(row[k]).strip() for k in label_keys if isinstance(row.get(k), str) and row[k].strip()),
                "",
            )
            if not file_name or not raw_label:
                dropped += 1
                continue
            if normalize_file_name is not None:
                file_name = normalize_file_name(file_name)
            mapped = label_resolver(raw_label)
            if mapped is None:
                dropped += 1
                continue
            # removeprefix, not lstrip: lstrip("./") strips any leading RUN
            # of '.'/'/' characters and would mangle dotfile-style names
            # ("..segment.wav" -> "segment.wav").
            normalized_name = file_name.replace("\\", "/").removeprefix("./")
            candidates = [root / normalized_name for root in roots]
            selected = next((c for c in candidates if c.is_file()), None)
            if selected is None:
                # Recursive search only on a direct miss — rglob per row is a
                # full tree walk and the direct path usually hits.
                basename = Path(normalized_name).name
                if basename:
                    selected = next(
                        (
                            c
                            for root in roots
                            for c in sorted(root.rglob(basename))
                            if c.is_file()
                        ),
                        None,
                    )
            if selected is None:
                dropped += 1
                continue
            rel = _relative_to_root(dataset_root, selected)
            existing = labels_by_file.get(rel)
            if existing is not None:
                if existing != mapped:
                    conflicts += 1
                dropped += 1
                continue
            labels_by_file[rel] = mapped

    write_labels_csv(labels_csv_path, labels_by_file)
    return GeneratedLabelsStats(rows_seen, len(labels_by_file), dropped, conflicts)


# Path-token resolvers reuse the strategy layer's multilingual maps
# (strategies.py mirrors reference `public_dataset_label_inference.py`).


def _token_resolver(path: Path) -> str | None:
    resolved = strategies.token_label(path)
    return resolved[0] if resolved else None


def _escorpus_resolver(path: Path) -> str | None:
    resolved = strategies.escorpus_pe_label(path)
    return resolved[0] if resolved else None


def _mesd_resolver(path: Path) -> str | None:
    resolved = strategies.mesd_label(path)
    return resolved[0] if resolved else None


def _att_hack_resolver(path: Path) -> str | None:
    resolved = strategies.att_hack_label(path)
    return resolved[0] if resolved else None


def _coraa_resolver(path: Path) -> str | None:
    resolved = strategies.coraa_ser_label(path)
    return resolved[0] if resolved else None


# --------------------------------------------------------------------------- #
# Provider download primitives
# --------------------------------------------------------------------------- #


def download_zenodo_archive(
    *,
    dataset_root: Path,
    record_id: str,
    file_key: str,
    transport: ProviderTransport,
    api_base: str = resolution.ZENODO_API_BASE,
) -> Path:
    """Record-API enumeration → md5/size-verified download of one file key."""
    payload = transport.request_json(resolution.zenodo_record_url(record_id, api_base=api_base))
    meta = resolution.select_zenodo_file(payload, file_key)
    return transport.download_file(
        meta.url,
        dataset_root / "downloads" / meta.key,
        expected_md5=meta.md5,
        expected_size=meta.size,
    )


def download_openslr_archives(
    *,
    dataset_root: Path,
    dataset_id: str,
    archive_suffixes: tuple[str, ...],
    transport: ProviderTransport,
    hf_script_url: str = resolution.OPENSLR_HF_SCRIPT_URL,
    listing_url: str | None = None,
    canonical_base: str = resolution.OPENSLR_CANONICAL_BASE,
) -> list[Path]:
    """The reference's three-rung resolution ladder, mirrors per artifact.

    1. pinned artifact lists (SLR88/SLR115) over the four mirror hosts;
    2. the Hugging Face openslr.py script's ``_RESOURCES`` table;
    3. the resource listing page's hrefs.
    """
    downloads_dir = dataset_root / "downloads"
    artifacts = list(resolution.resolve_openslr_pinned_artifacts(dataset_id, archive_suffixes))
    if not artifacts:
        try:
            script_text = transport.request_text(hf_script_url)
            file_names = resolution.extract_openslr_files_from_hf_script(script_text, dataset_id)
            urls = resolution.build_canonical_archive_urls(
                dataset_id, file_names, archive_suffixes, base_url=canonical_base
            )
            artifacts = [
                resolution.MirroredArtifact(file_name=Path(url).name, urls=(url,)) for url in urls
            ]
        except (TransportError, SyntaxError, ValueError) as err:
            # ValueError: ast.literal_eval on a _RESOURCES dict that is no
            # longer a pure literal — fall through to the listing-HTML rung.
            logger.warning("OpenSLR HF-script resolution failed for SLR%s: %s", dataset_id, err)
    if not artifacts:
        listing = listing_url or f"{canonical_base}/{dataset_id}/"
        html = transport.request_text(listing)
        urls = resolution.extract_archive_urls_from_listing_html(listing, html, archive_suffixes)
        artifacts = [
            resolution.MirroredArtifact(file_name=Path(url).name, urls=(url,)) for url in urls
        ]
    if not artifacts:
        raise RuntimeError(f"No OpenSLR archives resolved for SLR{dataset_id}.")

    paths: list[Path] = []
    for artifact in artifacts:
        last: Exception | None = None
        for url in artifact.urls:
            try:
                paths.append(transport.download_file(url, downloads_dir / artifact.file_name))
                break
            except TransportError as err:
                logger.warning("OpenSLR mirror failed for %s: %s", url, err)
                last = err
        else:
            raise TransportError(
                f"All mirrors failed for SLR{dataset_id}/{artifact.file_name}."
            ) from last
    return paths


def download_mendeley_dataset_tree(
    *,
    dataset_id: str,
    version: int,
    destination_root: Path,
    transport: ProviderTransport,
    api_base: str = resolution.MENDELEY_API_BASE,
) -> int:
    """Folder-tree walk of the Mendeley public API; returns files downloaded."""
    folders_payload = transport.request_json(
        resolution.mendeley_folders_url(dataset_id, version, api_base=api_base)
    )
    if not isinstance(folders_payload, list):
        raise RuntimeError("Unexpected Mendeley folder payload shape.")
    folder_paths = resolution.build_mendeley_folder_paths(
        [item for item in folders_payload if isinstance(item, dict)]
    )
    downloaded = 0
    for folder_id in ["root", *sorted(folder_paths)]:
        files_payload = transport.request_json(
            resolution.mendeley_files_url(dataset_id, folder_id, version, api_base=api_base),
            headers={"Accept": "application/vnd.mendeley-public-dataset.1+json"},
        )
        relative = Path(".") if folder_id == "root" else folder_paths[folder_id]
        for meta in resolution.select_mendeley_files(files_payload):
            transport.download_file(
                meta.url,
                _contained_destination(destination_root, relative, meta.key),
                expected_size=meta.size,
            )
            downloaded += 1
    return downloaded


def download_kaggle_archive(
    *,
    dataset_ref: str,
    destination: Path,
    transport: ProviderTransport,
    api_base: str = "https://www.kaggle.com/api/v1/datasets/download",
) -> Path:
    """Kaggle API download with Basic auth from KAGGLE_USERNAME/KAGGLE_KEY."""
    import base64

    username = os.getenv("KAGGLE_USERNAME", "").strip()
    key = os.getenv("KAGGLE_KEY", "").strip()
    if not (username and key):
        raise DatasetDownloadUnavailableError(
            f"Kaggle dataset {dataset_ref!r} needs credentials: set "
            "KAGGLE_USERNAME/KAGGLE_KEY, or stage the archive locally."
        )
    token = base64.b64encode(f"{username}:{key}".encode()).decode("ascii")
    return transport.download_file(
        f"{api_base}/{dataset_ref}",
        destination,
        headers={"Authorization": f"Basic {token}"},
    )


def download_jl_corpus_via_hf_rows(
    *,
    dataset_root: Path,
    labels_csv_path: Path,
    transport: ProviderTransport,
    rows_api_url: str = JL_CORPUS_HF_ROWS_API,
) -> GeneratedLabelsStats:
    """Pages the HF datasets-server rows API, saving audio + inferring labels."""
    hf_dataset, config, split, page_size = JL_CORPUS_HF
    audio_root = dataset_root / "raw" / "jl-corpus"
    audio_root.mkdir(parents=True, exist_ok=True)
    labels_by_file: dict[str, str] = {}
    files_seen = 0
    dropped = 0
    offset = 0
    while True:
        from urllib.parse import quote

        page = transport.request_json(
            f"{rows_api_url}?dataset={quote(hf_dataset, safe='')}&config={config}"
            f"&split={split}&offset={offset}&length={page_size}"
        )
        rows = page.get("rows") if isinstance(page, dict) else None
        if not isinstance(rows, list) or not rows:
            break
        for entry in rows:
            if not isinstance(entry, dict):
                continue
            row = entry.get("row")
            if not isinstance(row, dict):
                continue
            index = resolution.sanitize_jl_corpus_index(str(entry.get("row_idx", "")))
            src = next(
                (
                    resolution.extract_jl_corpus_audio_src(value)
                    for value in row.values()
                    if resolution.extract_jl_corpus_audio_src(value) is not None
                ),
                None,
            )
            if index is None or src is None:
                dropped += 1
                continue
            files_seen += 1
            file_name_raw = next(
                (str(v) for k, v in row.items() if "file" in k.lower() and isinstance(v, str)),
                f"row_{index}.wav",
            )
            safe_name = Path(file_name_raw.replace("\\", "/")).name or f"row_{index}.wav"
            destination = audio_root / safe_name
            if _relative_to_root(dataset_root, destination) in labels_by_file:
                # Duplicate basename across rows: without a unique name the
                # second row's download short-circuits on the existing file
                # while its label OVERWRITES the first row's — a silent
                # mislabel pairing row A's audio with row B's emotion.
                stem, suffix = Path(safe_name).stem, Path(safe_name).suffix
                safe_name = f"{stem}_row{index}{suffix}"
                destination = audio_root / safe_name
            transport.download_file(src, destination)
            label = _token_resolver(Path(safe_name))
            if label is None:
                dropped += 1
                continue
            labels_by_file[_relative_to_root(dataset_root, destination)] = label
        offset += page_size
    write_labels_csv(labels_csv_path, labels_by_file)
    return GeneratedLabelsStats(files_seen, len(labels_by_file), dropped, 0)


# --------------------------------------------------------------------------- #
# Per-dataset preparers (the 16-corpus catalog)
# --------------------------------------------------------------------------- #


def _zenodo_tree_preparer(
    *,
    dataset_root: Path,
    record_id: str,
    file_keys: tuple[str, ...],
    extract_dir: str,
    resolver: Callable[[Path], str | None],
    transport: ProviderTransport,
    zenodo_api_base: str,
) -> AutoDownloadArtifacts:
    """Shared shape: download key(s) → extract → infer labels from the tree."""
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    archives = [
        download_zenodo_archive(
            dataset_root=root,
            record_id=record_id,
            file_key=key,
            transport=transport,
            api_base=zenodo_api_base,
        )
        for key in file_keys
    ]
    extract_root = root / "raw" / extract_dir
    for archive in archives:
        ensure_extracted_archive(archive, extract_root)
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_audio_tree(
        dataset_root=root, search_root=extract_root, labels_csv_path=labels_csv, resolver=resolver
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "zenodo",
            "record_id": record_id,
            "file_keys": list(file_keys),
            "archive_paths": [str(path) for path in archives],
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_ravdess(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    """RAVDESS speech archive from Zenodo; labels come from filename codes."""
    record_id, file_key = RAVDESS_ZENODO
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    archive = download_zenodo_archive(
        dataset_root=root,
        record_id=record_id,
        file_key=file_key,
        transport=transport,
        api_base=zenodo_api_base,
    )
    ensure_extracted_archive(archive, root)
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "zenodo",
            "record_id": record_id,
            "file_key": file_key,
            "archive_path": str(archive),
        },
        labels_csv_path=None,
        labels_stats=None,
    )
    wav_count = sum(1 for p in sorted(root.rglob("*.wav")) if p.is_file())
    return AutoDownloadArtifacts(root, None, None, manifest, wav_count, 0)


def prepare_emodb_2(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    """EmoDB 2.0: archive + its ambiguous-categories metadata CSV → labels."""
    record_id, file_key = EMODB_2_ZENODO
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    archive = download_zenodo_archive(
        dataset_root=root,
        record_id=record_id,
        file_key=file_key,
        transport=transport,
        api_base=zenodo_api_base,
    )
    extract_root = root / "raw" / "emodb-2.0"
    ensure_extracted_archive(archive, extract_root)
    metadata_candidates = sorted(extract_root.rglob("db.emotion.categories.ambiguous.csv"))
    if not metadata_candidates:
        raise RuntimeError(
            "EmoDB 2.0 metadata `db.emotion.categories.ambiguous.csv` not found after extraction."
        )
    wav_roots = [path for path in sorted(extract_root.rglob("wav")) if path.is_dir()]
    if not wav_roots:
        raise RuntimeError("EmoDB 2.0 WAV directory not found after extraction.")
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_metadata_csv(
        dataset_root=root,
        metadata_csv_path=metadata_candidates[0],
        labels_csv_path=labels_csv,
        audio_search_roots=(wav_roots[0],),
        file_name_keys=("file",),
        label_keys=("emotion",),
        label_resolver=lambda raw: EMODB_LABEL_MAP.get(raw.strip().lower()),
        # The metadata CSV names files without extensions (reference
        # `zenodo_downloads.py:494-496` appends `.wav` the same way).
        normalize_file_name=lambda name: name if name.lower().endswith(".wav") else f"{name}.wav",
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "zenodo",
            "record_id": record_id,
            "file_key": file_key,
            "archive_path": str(archive),
            "metadata_csv_path": str(metadata_candidates[0]),
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_escorpus_pe(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    record_id, file_key = ESCORPUS_PE_ZENODO
    return _zenodo_tree_preparer(
        dataset_root=dataset_root,
        record_id=record_id,
        file_keys=(file_key,),
        extract_dir="escorpus-pe",
        resolver=_escorpus_resolver,
        transport=transport,
        zenodo_api_base=zenodo_api_base,
    )


def prepare_oreau_french_esd(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    record_id, rar_keys, doc_key = OREAU_ZENODO
    return _zenodo_tree_preparer(
        dataset_root=dataset_root,
        record_id=record_id,
        file_keys=(*rar_keys, doc_key),
        extract_dir="oreau-french-esd",
        resolver=_token_resolver,
        transport=transport,
        zenodo_api_base=zenodo_api_base,
    )


def prepare_cafe(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    record_id, archive_keys = CAFE_ZENODO
    return _zenodo_tree_preparer(
        dataset_root=dataset_root,
        record_id=record_id,
        file_keys=archive_keys,
        extract_dir="cafe",
        resolver=_token_resolver,
        transport=transport,
        zenodo_api_base=zenodo_api_base,
    )


def prepare_asvp_esd(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    record_id, file_key = ASVP_ESD_ZENODO
    return _zenodo_tree_preparer(
        dataset_root=dataset_root,
        record_id=record_id,
        file_keys=(file_key,),
        extract_dir="asvp-esd",
        resolver=_token_resolver,
        transport=transport,
        zenodo_api_base=zenodo_api_base,
    )


def prepare_spanish_meacorpus_2023(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    zenodo_api_base: str = resolution.ZENODO_API_BASE,
) -> AutoDownloadArtifacts:
    """MEACorpus: Zenodo ships only the metadata CSV; audio must be local."""
    record_id, metadata_key = MEACORPUS_ZENODO
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    metadata_path = download_zenodo_archive(
        dataset_root=root,
        record_id=record_id,
        file_key=metadata_key,
        transport=transport,
        api_base=zenodo_api_base,
    )
    stable = root / "metadata" / metadata_path.name
    stable.parent.mkdir(parents=True, exist_ok=True)
    if metadata_path != stable:
        shutil.copy2(metadata_path, stable)
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_metadata_csv(
        dataset_root=root,
        metadata_csv_path=stable,
        labels_csv_path=labels_csv,
        audio_search_roots=(root / "raw" / "spanish-meacorpus-2023",),
        file_name_keys=("filename", "file_name", "FileName"),
        label_keys=("label", "emotion", "EmoClass"),
        label_resolver=lambda raw: MEACORPUS_LABEL_MAP.get(raw.strip().lower()),
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "zenodo",
            "record_id": record_id,
            "metadata_key": metadata_key,
            "metadata_csv_path": str(stable),
            "audio_distribution_note": (
                "Audio clips are not redistributed in the Zenodo package; labels.csv "
                "only includes rows for locally available audio files."
            ),
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_mesd(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    mendeley_api_base: str = resolution.MENDELEY_API_BASE,
) -> AutoDownloadArtifacts:
    """MESD from the Mendeley public API; labels from filename prefixes."""
    dataset_id, version = MESD_MENDELEY
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    tree_root = root / "raw" / "mesd"
    count = download_mendeley_dataset_tree(
        dataset_id=dataset_id,
        version=version,
        destination_root=tree_root,
        transport=transport,
        api_base=mendeley_api_base,
    )
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_audio_tree(
        dataset_root=root, search_root=tree_root, labels_csv_path=labels_csv, resolver=_mesd_resolver
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "mendeley",
            "dataset_id": dataset_id,
            "version": version,
            "files_downloaded": count,
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def _openslr_preparer(
    *,
    dataset_root: Path,
    dataset_id: str,
    archive_suffixes: tuple[str, ...],
    extract_dir: str,
    resolver: Callable[[Path], str | None],
    extensions: frozenset[str],
    transport: ProviderTransport,
    hf_script_url: str,
    listing_url: str | None,
    canonical_base: str,
) -> AutoDownloadArtifacts:
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    archives = download_openslr_archives(
        dataset_root=root,
        dataset_id=dataset_id,
        archive_suffixes=archive_suffixes,
        transport=transport,
        hf_script_url=hf_script_url,
        listing_url=listing_url,
        canonical_base=canonical_base,
    )
    extract_root = root / "raw" / extract_dir
    for archive in archives:
        ensure_extracted_archive(archive, extract_root)
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_audio_tree(
        dataset_root=root,
        search_root=extract_root,
        labels_csv_path=labels_csv,
        resolver=resolver,
        extensions=extensions,
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "openslr",
            "dataset_id": dataset_id,
            "archive_paths": [str(path) for path in archives],
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_emov_db(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    hf_script_url: str = resolution.OPENSLR_HF_SCRIPT_URL,
    listing_url: str | None = None,
    canonical_base: str = resolution.OPENSLR_CANONICAL_BASE,
) -> AutoDownloadArtifacts:
    dataset_id, suffixes = EMOV_DB_OPENSLR
    return _openslr_preparer(
        dataset_root=dataset_root,
        dataset_id=dataset_id,
        archive_suffixes=suffixes,
        extract_dir="emov-db",
        resolver=_token_resolver,
        extensions=frozenset({".wav", ".flac"}),
        transport=transport,
        hf_script_url=hf_script_url,
        listing_url=listing_url,
        canonical_base=canonical_base,
    )


def prepare_att_hack(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    hf_script_url: str = resolution.OPENSLR_HF_SCRIPT_URL,
    listing_url: str | None = None,
    canonical_base: str = resolution.OPENSLR_CANONICAL_BASE,
) -> AutoDownloadArtifacts:
    dataset_id, suffixes = ATT_HACK_OPENSLR
    return _openslr_preparer(
        dataset_root=dataset_root,
        dataset_id=dataset_id,
        archive_suffixes=suffixes,
        extract_dir="att-hack",
        resolver=_att_hack_resolver,
        extensions=frozenset({".wav"}),
        transport=transport,
        hf_script_url=hf_script_url,
        listing_url=listing_url,
        canonical_base=canonical_base,
    )


def prepare_pavoque(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    release_url: str | None = None,
) -> AutoDownloadArtifacts:
    """PAVOQUE from the latest GitHub release's downloadable assets."""
    owner, repo = PAVOQUE_GITHUB
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    payload = transport.request_json(
        release_url or resolution.github_latest_release_url(owner, repo),
        headers={"Accept": "application/vnd.github+json", "X-GitHub-Api-Version": "2022-11-28"},
    )
    tag, assets = resolution.parse_github_release_assets(payload, owner=owner, repo=repo)
    downloads_dir = root / "downloads"
    extract_root = root / "raw" / "pavoque"
    archive_paths: list[Path] = []
    for asset in assets:
        path = transport.download_file(
            asset.url,
            _contained_destination(downloads_dir, asset.key),
            expected_size=asset.size,
        )
        archive_paths.append(path)
        if path.suffix.lower() in (".zip", ".gz", ".tgz", ".bz2", ".xz", ".tar"):
            ensure_extracted_archive(path, extract_root)
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_audio_tree(
        dataset_root=root,
        search_root=extract_root if extract_root.exists() else root,
        labels_csv_path=labels_csv,
        resolver=_token_resolver,
        extensions=frozenset({".wav", ".flac"}),
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={
            "provider": "github-release",
            "owner": owner,
            "repo": repo,
            "tag": tag,
            "archive_paths": [str(path) for path in archive_paths],
        },
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_jl_corpus(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    rows_api_url: str = JL_CORPUS_HF_ROWS_API,
) -> AutoDownloadArtifacts:
    """JL-Corpus: Kaggle archive when credentialed, HF rows API otherwise."""
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    labels_csv = root / LABELS_FILE_NAME
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    try:
        archive = download_kaggle_archive(
            dataset_ref=JL_CORPUS_KAGGLE_REF,
            destination=root / "downloads" / "jl-corpus.zip",
            transport=transport,
        )
        extract_root = root / "raw" / "jl-corpus"
        ensure_extracted_archive(archive, extract_root)
        stats = generate_labels_from_audio_tree(
            dataset_root=root,
            search_root=extract_root,
            labels_csv_path=labels_csv,
            resolver=_token_resolver,
        )
        source: dict[str, object] = {
            "provider": "kaggle",
            "dataset_ref": JL_CORPUS_KAGGLE_REF,
            "archive_path": str(archive),
        }
    except (DatasetDownloadUnavailableError, TransportError) as err:
        logger.warning("Kaggle path unavailable for jl-corpus (%s); trying HF rows API.", err)
        stats = download_jl_corpus_via_hf_rows(
            dataset_root=root,
            labels_csv_path=labels_csv,
            transport=transport,
            rows_api_url=rows_api_url,
        )
        source = {
            "provider": "huggingface-rows",
            "dataset_id": JL_CORPUS_HF[0],
            "rows_api_url": rows_api_url,
            "fallback_reason": str(err),
        }
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload=source,
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def prepare_crema_d(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,  # noqa: ARG001 - uniform signature
) -> AutoDownloadArtifacts:
    """CREMA-D ships via Git LFS: clone + pull, then validate materialization.

    When the tree exists, LFS-pointer validation runs (the real acquisition
    risk: a clone without ``git lfs pull`` leaves 130-byte pointer stubs where
    audio should be — reference ``adapters/crema_d.py:134``). Cloning itself
    needs git+network and raises the staging error when absent.
    """
    root = dataset_root.expanduser()
    audio_dir = root / "AudioWAV"
    if not audio_dir.is_dir():
        git = shutil.which("git")
        if git is None:
            raise DatasetDownloadUnavailableError(
                f"CREMA-D needs a Git-LFS clone of {CREMA_D_GIT} at {root}; git is not available."
            )
        completed = subprocess.run(  # noqa: S603 - fixed argv
            [git, "clone", "--depth", "1", CREMA_D_GIT, str(root)],
            capture_output=True,
            text=True,
            check=False,
        )
        if completed.returncode != 0:
            raise DatasetDownloadUnavailableError(
                f"CREMA-D clone failed ({completed.stderr.strip()[:200]}); clone "
                f"{CREMA_D_GIT} with `git lfs pull` on a connected machine and stage it at {root}."
            )
    pointers = resolution.scan_tree_for_lfs_pointers(audio_dir if audio_dir.is_dir() else root)
    if pointers:
        raise RuntimeError(
            f"CREMA-D audio is not materialized: {len(pointers)} files are Git-LFS "
            f"pointers (first: {pointers[0]}). Run `git lfs pull && git lfs checkout` "
            "in the dataset root, or re-stage a materialized copy."
        )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    wav_count = sum(1 for p in sorted(root.rglob("*.wav")) if p.is_file())
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={"provider": "github-lfs", "repository": CREMA_D_GIT},
        labels_csv_path=None,
        labels_stats=None,
    )
    return AutoDownloadArtifacts(root, None, None, manifest, wav_count, 0)


def prepare_coraa_ser(
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,  # noqa: ARG001 - uniform signature
) -> AutoDownloadArtifacts:
    """CORAA-SER lives in a Google Drive folder; gdown is required to fetch it."""
    root = dataset_root.expanduser()
    root.mkdir(parents=True, exist_ok=True)
    tree_root = root / "raw" / "coraa-ser"
    staged = tree_root.exists() and any(p.is_file() for p in tree_root.rglob("*"))
    if not staged:
        gdown = shutil.which("gdown")
        if gdown is None:
            raise DatasetDownloadUnavailableError(
                f"CORAA-SER downloads from a Google Drive folder ({CORAA_SER_GDRIVE_FOLDER}) "
                "and needs `gdown` in PATH (pip install gdown), or stage the files at "
                f"{tree_root}."
            )
        completed = subprocess.run(  # noqa: S603 - fixed argv
            [gdown, "--folder", "--fuzzy", "--continue", "-O", str(tree_root), CORAA_SER_GDRIVE_FOLDER],
            capture_output=True,
            text=True,
            check=False,
        )
        if completed.returncode != 0:
            raise DatasetDownloadUnavailableError(
                f"gdown folder download failed: {completed.stderr.strip()[:200]}"
            )
    labels_csv = root / LABELS_FILE_NAME
    stats = generate_labels_from_audio_tree(
        dataset_root=root, search_root=tree_root, labels_csv_path=labels_csv, resolver=_coraa_resolver
    )
    manifest = root / SOURCE_MANIFEST_FILE_NAME
    write_source_manifest(
        dataset_root=root,
        source_manifest_path=manifest,
        source_payload={"provider": "google-drive", "folder_url": CORAA_SER_GDRIVE_FOLDER},
        labels_csv_path=labels_csv,
        labels_stats=stats,
    )
    return AutoDownloadArtifacts(root, labels_csv, root, manifest, stats.files_seen, stats.labels_written)


def _manual_provider(dataset_id: str, instructions: str):
    def _prepare(dataset_root: Path, *, transport: ProviderTransport = DEFAULT_TRANSPORT):  # noqa: ARG001
        raise DatasetDownloadUnavailableError(
            f"Dataset {dataset_id!r} has no machine-downloadable distribution: "
            f"{instructions} Stage the files at {dataset_root} and re-run with "
            "skip_download=True."
        )

    return _prepare


#: dataset_id → acquisition workflow. Every catalog id resolves; license-gated
#: corpora raise the typed staging error with provider-specific instructions.
AUTO_PREPARERS: dict[str, Callable[..., AutoDownloadArtifacts]] = {
    "ravdess": prepare_ravdess,
    "emodb-2.0": prepare_emodb_2,
    "escorpus-pe": prepare_escorpus_pe,
    "oreau-french-esd": prepare_oreau_french_esd,
    "cafe": prepare_cafe,
    "asvp-esd": prepare_asvp_esd,
    "spanish-meacorpus-2023": prepare_spanish_meacorpus_2023,
    "mesd": prepare_mesd,
    "emov-db": prepare_emov_db,
    "att-hack": prepare_att_hack,
    "pavoque": prepare_pavoque,
    "jl-corpus": prepare_jl_corpus,
    "crema-d": prepare_crema_d,
    "coraa-ser": prepare_coraa_ser,
    "msp-podcast": _manual_provider(
        "msp-podcast",
        "request academic-license access from the MSP lab (or its HF mirror) first.",
    ),
    "biic-podcast": _manual_provider(
        "biic-podcast", "request access from the BIIC lab's distribution page."
    ),
}


def acquire_dataset(
    dataset_id: str,
    dataset_root: Path,
    *,
    transport: ProviderTransport = DEFAULT_TRANSPORT,
    **overrides,
) -> AutoDownloadArtifacts:
    """Runs one dataset's acquisition workflow; network failures become the
    typed staging error so callers keep one exception surface."""
    preparer = AUTO_PREPARERS.get(dataset_id)
    if preparer is None:
        raise KeyError(
            f"No acquisition workflow for {dataset_id!r}; known: "
            f"{', '.join(sorted(AUTO_PREPARERS))}."
        )
    try:
        artifacts = preparer(dataset_root, transport=transport, **overrides)
    except TransportError as err:
        raise DatasetDownloadUnavailableError(
            f"Acquiring {dataset_id!r} failed over the network ({err}). Fetch the "
            "data on a connected machine and stage it at "
            f"{dataset_root}, then re-run with skip_download=True."
        ) from err
    # Completion marker: a sentinel-less non-empty root is otherwise treated
    # as an interrupted extraction by materialize_dataset (rmtree'd when an
    # archive is offered) and as already-acquired by prepare_dataset (the
    # failed-acquisition mkdir residue would permanently disable retry).
    from ser_tpu_torch._internal.data.downloads import MATERIALIZED_SENTINEL

    try:
        (dataset_root / MATERIALIZED_SENTINEL).write_text(
            f"{dataset_id}\n", encoding="utf-8"
        )
    except OSError:  # the marker is an optimization, not a correctness gate
        logger.warning("Could not write completion marker under %s", dataset_root)
    return artifacts


__all__ = [
    "AUTO_PREPARERS",
    "AutoDownloadArtifacts",
    "EMODB_LABEL_MAP",
    "GeneratedLabelsStats",
    "LABELS_FILE_NAME",
    "MEACORPUS_LABEL_MAP",
    "SOURCE_MANIFEST_FILE_NAME",
    "acquire_dataset",
    "download_jl_corpus_via_hf_rows",
    "download_kaggle_archive",
    "download_mendeley_dataset_tree",
    "download_openslr_archives",
    "download_zenodo_archive",
    "ensure_extracted_archive",
    "generate_labels_from_audio_tree",
    "generate_labels_from_metadata_csv",
    "prepare_asvp_esd",
    "prepare_att_hack",
    "prepare_cafe",
    "prepare_coraa_ser",
    "prepare_crema_d",
    "prepare_emodb_2",
    "prepare_emov_db",
    "prepare_escorpus_pe",
    "prepare_jl_corpus",
    "prepare_mesd",
    "prepare_oreau_french_esd",
    "prepare_pavoque",
    "prepare_ravdess",
    "prepare_spanish_meacorpus_2023",
    "write_labels_csv",
    "write_source_manifest",
]
