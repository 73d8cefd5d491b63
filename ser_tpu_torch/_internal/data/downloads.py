"""Dataset acquisition: provider registry + local archive materialization.

Counterpart of ``ser_tpu/_internal/data/downloads.py``: the same fetch, extraction and sentinels.

Parity surface: reference per-provider download owners
(``ser/_internal/data/*_downloads.py``: zenodo, openslr, mendeley, msp mirror,
provider, jl_corpus) and its archive extraction module. This module owns the
fetch/extract/materialize core (resumable checksum-verified ``fetch_url``,
traversal-safe extraction, completion sentinels); the per-provider workflows
live in :mod:`provider_prepare` over :mod:`provider_transport`, and
:func:`materialize_dataset` also works from archives the operator staged
locally for zero-egress runtimes.
"""

from __future__ import annotations

import shutil
import tarfile
import zipfile
from dataclasses import dataclass
from pathlib import Path

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)


class DatasetDownloadUnavailableError(RuntimeError):
    """Raised when acquiring a dataset would require network access."""


class ArchiveError(ValueError):
    """Raised for unsupported or unsafe archives."""


@dataclass(frozen=True)
class ProviderSpec:
    """One acquisition provider: where the data lives and how it unpacks."""

    provider_id: str
    description: str
    url_template: str
    archive_kinds: tuple[str, ...] = ("zip", "tar")


PROVIDERS: dict[str, ProviderSpec] = {
    "zenodo": ProviderSpec(
        "zenodo",
        "Zenodo record downloads (e.g. RAVDESS record 1188976)",
        "https://zenodo.org/record/{record_id}/files/{file_name}",
    ),
    "openslr": ProviderSpec(
        "openslr",
        "OpenSLR resource mirrors (EmoV-DB, PAVOQUE)",
        "https://www.openslr.org/resources/{resource_id}/{file_name}",
    ),
    "mendeley": ProviderSpec(
        "mendeley",
        "Mendeley Data datasets (MESD)",
        "https://data.mendeley.com/public-files/datasets/{dataset_id}/files/{file_id}",
    ),
    "github-lfs": ProviderSpec(
        "github-lfs",
        "Git-LFS hosted corpora (CREMA-D); clone + `git lfs pull`",
        "https://github.com/{repo}.git",
    ),
    "msp-mirror": ProviderSpec(
        "msp-mirror",
        "MSP-Podcast academic mirror (license-gated account required)",
        "https://ecs.utdallas.edu/research/researchlabs/msp-lab/{file_name}",
    ),
    "provider": ProviderSpec(
        "provider",
        "Direct provider pages requiring manual acceptance",
        "{url}",
    ),
}


def fetch_from_provider(provider_id: str, *, dataset_id: str | None = None, dataset_root=None):
    """Runs the per-dataset acquisition workflow for one provider-backed corpus.

    The real machinery lives in :mod:`provider_prepare` (zenodo record
    enumeration, OpenSLR mirror ladder, Mendeley tree walk, GitHub releases,
    Kaggle/HF-rows, Git-LFS validation) over an injectable transport; this
    facade keeps the historical (provider-first) signature. Without a
    ``dataset_id`` there is nothing to acquire — the typed staging error
    explains where the data lives.
    """
    spec = PROVIDERS.get(provider_id)
    if dataset_id is not None and dataset_root is not None:
        from ser_tpu_torch._internal.data.provider_prepare import acquire_dataset

        return acquire_dataset(dataset_id, Path(dataset_root))
    hint = f" ({spec.description}; {spec.url_template})" if spec else ""
    raise DatasetDownloadUnavailableError(
        f"Fetch the archive from provider {provider_id!r}{hint} on a connected "
        "machine and pass its local path to materialize_dataset()/`ser data "
        "prepare`, or call acquire_dataset(dataset_id, dataset_root) for the "
        "full acquisition workflow."
    )


def _safe_members(names: list[str], destination: Path) -> None:
    """Rejects path-traversal members before extraction.

    The containment check is separator-aware: a plain ``startswith`` would
    approve members landing in a SIBLING directory whose name merely has the
    destination as a string prefix (``/data/mesd`` vs ``/data/mesd-evil``).
    """
    root = destination.resolve()
    for name in names:
        target = (destination / name).resolve()
        if target != root and not target.is_relative_to(root):
            raise ArchiveError(f"Archive member escapes destination: {name!r}")


def extract_archive(archive_path: str | Path, destination: str | Path) -> list[str]:
    """Extracts one staged zip/tar archive; returns extracted member names.

    Mirrors the reference's archive-extraction owner including traversal
    protection.
    """
    archive = Path(archive_path)
    destination = Path(destination)
    destination.mkdir(parents=True, exist_ok=True)
    if not archive.exists():
        raise FileNotFoundError(f"Archive not found: {archive}")

    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as handle:
            names = handle.namelist()
            _safe_members(names, destination)
            handle.extractall(destination)
            return names
    if tarfile.is_tarfile(archive):
        with tarfile.open(archive) as handle:
            names = handle.getnames()
            _safe_members(names, destination)
            handle.extractall(destination, filter="data")
            return names
    raise ArchiveError(f"Unsupported archive format: {archive.name}")


@dataclass(frozen=True)
class FetchResult:
    """Outcome of one resumable fetch."""

    path: str
    bytes_fetched: int
    resumed: bool
    sha256: str


class ChecksumMismatchError(ValueError):
    """Raised when a fetched file fails its expected digest."""


def _sha256_of(path: Path) -> str:
    from hashlib import sha256

    digest = sha256()
    with path.open("rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def fetch_url(
    url: str,
    destination: str | Path,
    *,
    expected_sha256: str | None = None,
    chunk_bytes: int = 1 << 20,
    timeout_seconds: float = 60.0,
    headers: dict[str, str] | None = None,
) -> FetchResult:
    """Resumable, checksum-verified fetch into ``destination``.

    The download-owner core the reference spreads across its per-provider
    modules (``zenodo_downloads.py``, ``openslr_downloads.py`` …): stream
    into a ``.part`` staging file, resume from its offset on retry (HTTP
    Range for http(s); seek for ``file://``), rename atomically, verify the
    digest. ``file://`` URLs make every path testable with zero egress; a
    connected deployment uses the same function for live providers.
    """
    from urllib.parse import urlparse
    from urllib.request import Request, url2pathname, urlopen

    destination = Path(destination)
    destination.parent.mkdir(parents=True, exist_ok=True)
    staging = destination.with_name(destination.name + ".part")

    if destination.exists():
        digest = _sha256_of(destination)
        if expected_sha256 is None or digest == expected_sha256:
            return FetchResult(str(destination), 0, False, digest)
        destination.unlink()  # stale/corrupt: refetch

    # Resume ONLY when a digest will vouch for the spliced result: a remote
    # file that changed between attempts would otherwise splice old+new
    # bytes into a silently corrupt download.
    if staging.exists() and expected_sha256 is None:
        staging.unlink()
    offset = staging.stat().st_size if staging.exists() else 0
    resumed = offset > 0
    parsed = urlparse(url)
    fetched = 0
    if parsed.scheme == "file":
        source_path = Path(url2pathname(parsed.path))
        with source_path.open("rb") as source, staging.open("ab") as sink:
            source.seek(offset)
            for chunk in iter(lambda: source.read(chunk_bytes), b""):
                sink.write(chunk)
                fetched += len(chunk)
    elif parsed.scheme in ("http", "https"):
        from urllib.error import HTTPError
        from urllib.request import HTTPRedirectHandler, build_opener

        class _AuthStrippingRedirect(HTTPRedirectHandler):
            """Drops Authorization when a redirect changes host.

            urllib re-sends ALL original headers on redirect (unlike
            `requests`). Credentialed APIs (Kaggle) 302 to signed storage
            URLs (GCS) that reject requests carrying both a signature and an
            Authorization header — and forwarding credentials to a third
            host leaks them.
            """

            def redirect_request(self, req, fp, code, msg, hdrs, newurl):
                new = super().redirect_request(req, fp, code, msg, hdrs, newurl)
                if new is not None and urlparse(newurl).netloc != urlparse(req.full_url).netloc:
                    new.headers = {
                        k: v for k, v in new.headers.items() if k.lower() != "authorization"
                    }
                return new

        opener = build_opener(_AuthStrippingRedirect)
        request = Request(url, headers=dict(headers or {}))
        if offset:
            request.add_header("Range", f"bytes={offset}-")
        try:
            with opener.open(request, timeout=timeout_seconds) as response:  # noqa: S310
                if offset and response.status == 200:
                    # Server ignored the Range request: restart from zero.
                    staging.unlink()
                    offset, resumed = 0, False
                    staging.touch()
                with staging.open("ab") as sink:
                    for chunk in iter(lambda: response.read(chunk_bytes), b""):
                        sink.write(chunk)
                        fetched += len(chunk)
        except HTTPError as err:
            if not (err.code == 416 and offset):
                raise
            # 416 with a non-empty .part: a prior run wrote the whole file
            # but crashed before the rename. Fall through to digest
            # validation of the staging file as-is.
    else:
        raise ValueError(f"Unsupported URL scheme {parsed.scheme!r} for {url}.")

    digest = _sha256_of(staging)
    if expected_sha256 is not None and digest != expected_sha256:
        staging.unlink()
        raise ChecksumMismatchError(
            f"{url}: digest {digest} != expected {expected_sha256}; partial data "
            "discarded — retry the fetch."
        )
    staging.replace(destination)
    return FetchResult(str(destination), fetched, resumed, digest)


def fetch_and_materialize(
    *,
    dataset_id: str,
    url: str,
    destination: Path,
    expected_sha256: str | None = None,
    archive_dir: Path | None = None,
) -> Path:
    """Fetch (resume+verify) an archive and extract it to the dataset root."""
    archive_dir = archive_dir if archive_dir is not None else destination.parent
    archive_path = archive_dir / Path(url.split("?", 1)[0]).name
    fetch_url(url, archive_path, expected_sha256=expected_sha256)
    return materialize_dataset(
        dataset_id=dataset_id, archive_path=archive_path, destination=destination
    )


#: Completion sentinel written after a successful extraction — a non-empty
#: destination WITHOUT it is a partial (interrupted) extraction, not a
#: materialized dataset.
MATERIALIZED_SENTINEL = ".ser-materialized"


def materialize_dataset(
    *,
    dataset_id: str,
    archive_path: Path | None,
    destination: Path,
) -> Path:
    """Materializes a dataset from a staged local archive (or verifies in-place).

    Returns the dataset root ready for ``prepare_dataset``. Our own
    extractions mark completion with :data:`MATERIALIZED_SENTINEL`; a
    non-empty destination without the marker re-extracts when an archive is
    available (an interrupted extraction must not silently truncate the
    manifest), and is accepted as an operator-staged tree otherwise.
    """
    sentinel = destination / MATERIALIZED_SENTINEL
    if destination.exists() and any(destination.iterdir()):
        if sentinel.exists() or archive_path is None:
            logger.info("Dataset %s already materialized at %s", dataset_id, destination)
            return destination
        logger.warning(
            "Dataset %s at %s has no completion marker (interrupted "
            "extraction?); re-extracting from %s",
            dataset_id,
            destination,
            archive_path,
        )
        shutil.rmtree(destination)
    if archive_path is None:
        from ser_tpu_torch._internal.data.catalog import get_dataset_spec

        return fetch_from_provider(
            get_dataset_spec(dataset_id).provider,
            dataset_id=dataset_id,
            dataset_root=destination,
        ).dataset_root
    members = extract_archive(archive_path, destination)
    sentinel.write_text(f"{dataset_id}\n", encoding="utf-8")
    logger.info("Extracted %d members for %s into %s", len(members), dataset_id, destination)
    return destination


__all__ = [
    "ArchiveError",
    "ChecksumMismatchError",
    "DatasetDownloadUnavailableError",
    "FetchResult",
    "MATERIALIZED_SENTINEL",
    "PROVIDERS",
    "extract_archive",
    "fetch_and_materialize",
    "fetch_from_provider",
    "fetch_url",
    "materialize_dataset",
]
