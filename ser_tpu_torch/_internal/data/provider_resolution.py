"""Pure provider-metadata resolution: payload parsing, URL building, pointers.

Counterpart of ``ser_tpu/_internal/data/provider_resolution.py``: the same parses of the same payloads.

Parity surface: the resolution halves of the reference's per-provider owners —
``ser/_internal/data/zenodo_downloads.py:128-172`` (md5 tokens, record-file
selection), ``openslr_resolution.py:22-182`` (mirror templates, pinned
artifacts, HF-script/listing-HTML URL extraction), ``provider_downloads.py:286-336``
(GitHub latest-release assets), ``mendeley_downloads.py:63-101`` (folder-tree
path building), ``jl_corpus_downloads.py:93-120`` (HF rows sanitization), and
the CREMA-D adapter's Git-LFS pointer detection (``adapters/crema_d.py:23-40``).

Everything here is pure (no IO): each function maps already-fetched payloads to
typed values, so the whole resolution surface is unit-testable with zero
egress. Transport lives in :mod:`provider_transport`; orchestration in
:mod:`provider_prepare`.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from urllib import parse

# --------------------------------------------------------------------------- #
# Zenodo
# --------------------------------------------------------------------------- #

ZENODO_API_BASE = "https://zenodo.org/api/records"


@dataclass(frozen=True)
class RemoteFileMetadata:
    """Resolved download metadata for one provider-hosted file."""

    key: str
    url: str
    md5: str | None = None
    size: int | None = None


def parse_zenodo_md5(checksum: str | None) -> str | None:
    """Extracts the digest from a Zenodo ``md5:<hex>`` checksum token."""
    if checksum is None:
        return None
    normalized = checksum.strip().lower()
    if normalized.startswith("md5:"):
        digest = normalized.removeprefix("md5:").strip()
        return digest or None
    return None


def zenodo_record_url(record_id: str, *, api_base: str = ZENODO_API_BASE) -> str:
    """Record-metadata endpoint for one Zenodo record id."""
    return f"{api_base}/{record_id}"


def select_zenodo_file(record_payload: object, file_key: str) -> RemoteFileMetadata:
    """Finds one file key in a Zenodo record payload and resolves its URL.

    Matches the reference's strict shape checks: a payload that is not a dict,
    has no ``files`` list, or carries the key without a usable ``links.self``
    raises rather than guessing.
    """
    if not isinstance(record_payload, dict):
        raise RuntimeError("Unexpected Zenodo record payload shape.")
    files = record_payload.get("files")
    if not isinstance(files, list):
        raise RuntimeError("Zenodo record does not expose files metadata.")
    for entry in files:
        if not isinstance(entry, dict) or entry.get("key") != file_key:
            continue
        links = entry.get("links")
        if not isinstance(links, dict):
            break
        url = links.get("self")
        if not isinstance(url, str) or not url:
            break
        checksum = entry.get("checksum")
        size_raw = entry.get("size")
        return RemoteFileMetadata(
            key=file_key,
            url=url,
            md5=parse_zenodo_md5(checksum if isinstance(checksum, str) else None),
            size=size_raw if isinstance(size_raw, int) and size_raw >= 0 else None,
        )
    raise RuntimeError(f"Zenodo record does not contain expected file key {file_key!r}.")


# --------------------------------------------------------------------------- #
# OpenSLR
# --------------------------------------------------------------------------- #

OPENSLR_HF_SCRIPT_URL = "https://huggingface.co/datasets/openslr/openslr/raw/main/openslr.py"
OPENSLR_CANONICAL_BASE = "https://openslr.org/resources"

#: Ordered mirror templates; the canonical host first, then community mirrors.
OPENSLR_MIRROR_TEMPLATES: tuple[str, ...] = (
    "https://openslr.org/resources/{dataset_id}/{file_name}",
    "https://openslr.trmal.net/resources/{dataset_id}/{file_name}",
    "https://openslr.elda.org/resources/{dataset_id}/{file_name}",
    "https://openslr.magicdatatech.com/resources/{dataset_id}/{file_name}",
)


@dataclass(frozen=True)
class MirroredArtifact:
    """One pinned artifact name with its ordered mirror URLs."""

    file_name: str
    urls: tuple[str, ...]


def build_openslr_mirror_urls(dataset_id: str, file_name: str) -> MirroredArtifact:
    """Expands one (SLR id, file) pair over the mirror templates in order."""
    return MirroredArtifact(
        file_name=file_name,
        urls=tuple(
            template.format(dataset_id=dataset_id, file_name=file_name)
            for template in OPENSLR_MIRROR_TEMPLATES
        ),
    )


#: Pinned archive lists for the catalog's OpenSLR corpora (same sets as the
#: reference's `_OPENSLR_PINNED_ARTIFACTS`): SLR88 = Att-HACK, SLR115 = EmoV-DB.
OPENSLR_PINNED_FILES: dict[str, tuple[str, ...]] = {
    "88": ("wav.tgz", "txt.tgz"),
    "115": (
        "bea_Amused.tar.gz",
        "bea_Angry.tar.gz",
        "bea_Disgusted.tar.gz",
        "bea_Neutral.tar.gz",
        "bea_Sleepy.tar.gz",
        "jenie_Amused.tar.gz",
        "jenie_Angry.tar.gz",
        "jenie_Disgusted.tar.gz",
        "jenie_Neutral.tar.gz",
        "jenie_Sleepy.tar.gz",
        "josh_Amused.tar.gz",
        "josh_Neutral.tar.gz",
        "josh_Sleepy.tar.gz",
        "sam_Amused.tar.gz",
        "sam_Angry.tar.gz",
        "sam_Disgusted.tar.gz",
        "sam_Neutral.tar.gz",
        "sam_Sleepy.tar.gz",
    ),
}


def resolve_openslr_pinned_artifacts(
    dataset_id: str, archive_suffixes: tuple[str, ...]
) -> tuple[MirroredArtifact, ...]:
    """Pinned artifacts for one SLR id filtered by archive suffix."""
    file_names = OPENSLR_PINNED_FILES.get(dataset_id)
    if file_names is None:
        return ()
    suffixes = tuple(suffix.lower() for suffix in archive_suffixes)
    return tuple(
        build_openslr_mirror_urls(dataset_id, name)
        for name in file_names
        if name.lower().endswith(suffixes)
    )


def extract_href_values(html_text: str) -> list[str]:
    """Non-empty href attribute values from one HTML payload."""
    found = re.findall(r"""href\s*=\s*["']([^"']+)["']""", html_text, flags=re.IGNORECASE)
    return [value.strip() for value in found if value.strip()]


def extract_openslr_files_from_hf_script(script_text: str, dataset_id: str) -> list[str]:
    """File names for one SLR id from the Hugging Face openslr.py script.

    The script pins ``_RESOURCES = {"SLR<id>": {"Files": [...]}}`` as a module
    literal; `ast.literal_eval` over the assignment reads it without executing
    untrusted code.
    """
    module = ast.parse(script_text, mode="exec")
    resources: object | None = None
    for statement in module.body:
        if not isinstance(statement, ast.Assign):
            continue
        if any(isinstance(t, ast.Name) and t.id == "_RESOURCES" for t in statement.targets):
            resources = ast.literal_eval(statement.value)
            break
    if not isinstance(resources, dict):
        return []
    entry = resources.get(f"SLR{dataset_id}")
    if not isinstance(entry, dict):
        return []
    raw_files = entry.get("Files")
    if not isinstance(raw_files, list):
        return []
    return [value.strip() for value in raw_files if isinstance(value, str) and value.strip()]


def build_canonical_archive_urls(
    dataset_id: str,
    file_names: list[str],
    archive_suffixes: tuple[str, ...],
    *,
    base_url: str = OPENSLR_CANONICAL_BASE,
) -> list[str]:
    """Canonical, deduplicated OpenSLR URLs for suffix-matching file names."""
    suffixes = tuple(suffix.lower() for suffix in archive_suffixes)
    urls: list[str] = []
    seen: set[str] = set()
    for file_name in file_names:
        if not file_name.lower().endswith(suffixes):
            continue
        url = f"{base_url}/{dataset_id}/{file_name}"
        if url not in seen:
            seen.add(url)
            urls.append(url)
    return urls


def extract_archive_urls_from_listing_html(
    listing_url: str, html_text: str, archive_suffixes: tuple[str, ...]
) -> list[str]:
    """Absolute archive URLs from one resource-listing HTML page."""
    suffixes = tuple(suffix.lower() for suffix in archive_suffixes)
    urls: list[str] = []
    seen: set[str] = set()
    for href in extract_href_values(html_text):
        url = parse.urljoin(listing_url, href)
        lowered = url.lower()
        if not lowered.startswith(("http://", "https://")):
            continue
        if not lowered.endswith(suffixes):
            continue
        if url not in seen:
            seen.add(url)
            urls.append(url)
    return urls


# --------------------------------------------------------------------------- #
# GitHub releases + Git LFS
# --------------------------------------------------------------------------- #


def github_latest_release_url(owner: str, repo: str) -> str:
    return f"https://api.github.com/repos/{owner}/{repo}/releases/latest"


def parse_github_release_assets(
    payload: object, *, owner: str, repo: str
) -> tuple[str, list[RemoteFileMetadata]]:
    """(tag_name, downloadable assets) from one latest-release payload."""
    if not isinstance(payload, dict):
        raise RuntimeError(f"Unexpected GitHub release payload for {owner}/{repo}.")
    tag_raw = payload.get("tag_name")
    tag = str(tag_raw).strip() if tag_raw is not None else ""
    if not tag:
        raise RuntimeError(f"GitHub latest release for {owner}/{repo} has no tag_name.")
    assets_raw = payload.get("assets")
    if not isinstance(assets_raw, list):
        raise RuntimeError(f"GitHub latest release for {owner}/{repo} has no assets.")
    assets: list[RemoteFileMetadata] = []
    for item in assets_raw:
        if not isinstance(item, dict):
            continue
        name = item.get("name")
        url = item.get("browser_download_url")
        if not isinstance(name, str) or not name.strip():
            continue
        if not isinstance(url, str) or not url.strip():
            continue
        size_raw = item.get("size")
        assets.append(
            RemoteFileMetadata(
                key=name.strip(),
                url=url.strip(),
                size=size_raw if isinstance(size_raw, int) and size_raw >= 0 else None,
            )
        )
    if not assets:
        raise RuntimeError(f"GitHub latest release for {owner}/{repo} has no assets.")
    return tag, assets


GIT_LFS_POINTER_PREFIX = b"version https://git-lfs.github.com/spec/v1"

_LFS_OID = re.compile(r"^oid sha256:([0-9a-f]{64})$", re.MULTILINE)
_LFS_SIZE = re.compile(r"^size (\d+)$", re.MULTILINE)


@dataclass(frozen=True)
class LfsPointer:
    """Parsed Git-LFS pointer: the real object's digest and size."""

    oid_sha256: str
    size: int


def is_lfs_pointer_file(path: Path) -> bool:
    """Whether one on-disk file is an unmaterialized Git-LFS pointer."""
    try:
        with path.open("rb") as handle:
            prefix = handle.read(len(GIT_LFS_POINTER_PREFIX))
    except OSError:
        return False
    return prefix == GIT_LFS_POINTER_PREFIX


def parse_lfs_pointer(text: str) -> LfsPointer:
    """Parses one LFS pointer body; raises on malformed pointers."""
    if not text.startswith(GIT_LFS_POINTER_PREFIX.decode("ascii")):
        raise ValueError("Not a Git-LFS pointer (missing version line).")
    oid = _LFS_OID.search(text)
    size = _LFS_SIZE.search(text)
    if oid is None or size is None:
        raise ValueError("Malformed Git-LFS pointer: missing oid/size lines.")
    return LfsPointer(oid_sha256=oid.group(1), size=int(size.group(1)))


def scan_tree_for_lfs_pointers(
    root: Path, *, extensions: frozenset[str] = frozenset({".wav", ".flac", ".mp3"})
) -> list[Path]:
    """All audio files under ``root`` that are still LFS pointers.

    The CREMA-D materialization check (reference ``adapters/crema_d.py:134``):
    a cloned tree whose audio is pointer stubs must fail preparation with a
    ``git lfs pull`` hint instead of feeding 130-byte "audio" into training.
    """
    pointers: list[Path] = []
    for path in sorted(root.rglob("*")):
        if path.is_file() and path.suffix.lower() in extensions and is_lfs_pointer_file(path):
            pointers.append(path)
    return pointers


# --------------------------------------------------------------------------- #
# Mendeley Data
# --------------------------------------------------------------------------- #

MENDELEY_API_BASE = "https://data.mendeley.com/public-api/datasets"


def mendeley_folders_url(dataset_id: str, version: int, *, api_base: str = MENDELEY_API_BASE) -> str:
    return f"{api_base}/{dataset_id}/folders/{version}"


def mendeley_files_url(
    dataset_id: str, folder_id: str, version: int, *, api_base: str = MENDELEY_API_BASE
) -> str:
    return f"{api_base}/{dataset_id}/files?folder_id={folder_id}&version={version}"


def build_mendeley_folder_paths(folders: list[dict[str, object]]) -> dict[str, Path]:
    """Safe local relative paths for one Mendeley folder tree.

    Resolves parent chains with cycle detection; names are sanitized to
    filesystem-safe tokens, falling back to the folder id when sanitization
    empties the name.
    """
    by_id: dict[str, dict[str, object]] = {}
    for item in folders:
        folder_id = item.get("id")
        if isinstance(folder_id, str) and folder_id:
            by_id[folder_id] = item

    cache: dict[str, Path] = {}

    def _resolve(folder_id: str, seen: set[str]) -> Path:
        cached = cache.get(folder_id)
        if cached is not None:
            return cached
        if folder_id in seen:
            raise RuntimeError("Cycle detected while resolving Mendeley folder paths.")
        seen.add(folder_id)
        item = by_id[folder_id]
        raw_name = item.get("name")
        name = str(raw_name).strip() if raw_name is not None else folder_id
        safe = re.sub(r"[^0-9a-zA-Z._-]+", "_", name).strip("._-") or folder_id
        parent_raw = item.get("parent_id")
        if isinstance(parent_raw, str) and parent_raw and parent_raw in by_id:
            resolved = _resolve(parent_raw, seen) / safe
        else:
            resolved = Path(safe)
        cache[folder_id] = resolved
        seen.remove(folder_id)
        return resolved

    for folder_id in by_id:
        _resolve(folder_id, set())
    return cache


def select_mendeley_files(payload: object) -> list[RemoteFileMetadata]:
    """Downloadable file entries from one Mendeley files listing."""
    if not isinstance(payload, list):
        raise RuntimeError("Unexpected Mendeley files payload shape.")
    files: list[RemoteFileMetadata] = []
    for entry in payload:
        if not isinstance(entry, dict):
            continue
        filename = entry.get("filename")
        if not isinstance(filename, str) or not filename.strip():
            continue
        details = entry.get("content_details")
        if not isinstance(details, dict):
            continue
        url = details.get("download_url")
        if not isinstance(url, str) or not url:
            continue
        size_raw = entry.get("size")
        files.append(
            RemoteFileMetadata(
                key=filename.strip(),
                url=url,
                size=size_raw if isinstance(size_raw, int) and size_raw >= 0 else None,
            )
        )
    return files


# --------------------------------------------------------------------------- #
# JL-Corpus Hugging Face rows API
# --------------------------------------------------------------------------- #


def sanitize_jl_corpus_index(index: str) -> str | None:
    """Filesystem-safe row index token (digits only) or None."""
    token = index.strip()
    return token if token.isdigit() else None


def extract_jl_corpus_audio_src(value: object) -> str | None:
    """The audio source URL from one HF rows-API cell value.

    The rows API renders audio cells as a list of ``{"src": ..., "type": ...}``
    dicts; the first non-empty src wins.
    """
    if isinstance(value, list):
        for item in value:
            if isinstance(item, dict):
                src = item.get("src")
                if isinstance(src, str) and src.strip():
                    return src.strip()
    if isinstance(value, dict):
        src = value.get("src")
        if isinstance(src, str) and src.strip():
            return src.strip()
    return None


__all__ = [
    "GIT_LFS_POINTER_PREFIX",
    "MENDELEY_API_BASE",
    "OPENSLR_CANONICAL_BASE",
    "OPENSLR_HF_SCRIPT_URL",
    "OPENSLR_MIRROR_TEMPLATES",
    "OPENSLR_PINNED_FILES",
    "ZENODO_API_BASE",
    "LfsPointer",
    "MirroredArtifact",
    "RemoteFileMetadata",
    "build_canonical_archive_urls",
    "build_mendeley_folder_paths",
    "build_openslr_mirror_urls",
    "extract_archive_urls_from_listing_html",
    "extract_href_values",
    "extract_jl_corpus_audio_src",
    "extract_openslr_files_from_hf_script",
    "github_latest_release_url",
    "is_lfs_pointer_file",
    "mendeley_files_url",
    "mendeley_folders_url",
    "parse_github_release_assets",
    "parse_lfs_pointer",
    "parse_zenodo_md5",
    "resolve_openslr_pinned_artifacts",
    "sanitize_jl_corpus_index",
    "scan_tree_for_lfs_pointers",
    "select_mendeley_files",
    "select_zenodo_file",
    "zenodo_record_url",
]
