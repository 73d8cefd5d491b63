"""Provider transport: retrying JSON/file fetches with integrity checks.

Counterpart of ``ser_tpu/_internal/data/provider_transport.py``: the same retries, checks and staging.

Parity surface: reference ``ser/_internal/data/provider_downloads.py:74-283``
(retry classification, jittered backoff, disk-space preflight, md5/size
verification, atomic staging) re-expressed over this repo's resumable
``downloads.fetch_url`` core.

Every function accepts ``file://`` URLs, so the whole transport is testable
with zero egress; a connected deployment uses the same code paths for live
providers. Orchestration injects a :class:`ProviderTransport`, letting tests
substitute fixture-backed fetchers without monkeypatching modules.
"""

from __future__ import annotations

import hashlib
import json
import random
import shutil
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from pathlib import Path
from typing import TypeVar
from urllib import error, request

from ser_tpu_torch._internal.data.downloads import fetch_url
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

DEFAULT_TIMEOUT_SECONDS = 60.0
DEFAULT_RETRIES = 3
DEFAULT_RETRY_BASE_SECONDS = 1.0
_CHUNK = 1 << 20

T = TypeVar("T")


def is_retryable_http_status(status_code: int) -> bool:
    """429 and 5xx are transient; everything else fails fast."""
    return status_code == 429 or 500 <= status_code <= 599


def run_with_retries(
    *,
    description: str,
    action: Callable[[], T],
    retries: int = DEFAULT_RETRIES,
    retry_base_seconds: float = DEFAULT_RETRY_BASE_SECONDS,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Bounded retries with linear+jitter backoff; non-retryable HTTP fails fast."""
    if retries < 1:
        raise ValueError("Retry count must be at least 1.")
    last_error: Exception | None = None
    for attempt in range(1, retries + 1):
        try:
            return action()
        except error.HTTPError as err:
            if not is_retryable_http_status(err.code):
                raise TransportError(f"{description} failed with HTTP {err.code}") from err
            last_error = err
        except (error.URLError, TimeoutError, OSError) as err:
            last_error = err
        if attempt < retries:
            delay = retry_base_seconds * attempt + random.uniform(0.0, retry_base_seconds)
            logger.warning(
                "%s failed (attempt=%d/%d); retrying in %.2fs", description, attempt, retries, delay
            )
            sleep(delay)
    raise TransportError(f"{description} failed after {retries} attempts.") from last_error


def request_json(
    url: str,
    *,
    headers: dict[str, str] | None = None,
    timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
    retries: int = DEFAULT_RETRIES,
) -> object:
    """GET one JSON payload (http(s) or ``file://``) with retries."""

    def _action() -> object:
        req = request.Request(
            url,
            headers={
                "Accept": "application/json",
                "User-Agent": "ser-tpu-data/1.0",
                **(headers or {}),
            },
        )
        with request.urlopen(req, timeout=timeout_seconds) as response:  # noqa: S310
            payload = response.read()
        try:
            return json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as err:
            # An HTML maintenance page behind HTTP 200 must surface as the
            # typed transport failure (and be retried), not escape raw.
            raise TransportError(f"{url}: response body is not JSON ({err}).") from err

    return run_with_retries(description=f"GET {url}", action=_action, retries=retries)


def request_text(
    url: str,
    *,
    headers: dict[str, str] | None = None,
    timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
    retries: int = DEFAULT_RETRIES,
) -> str:
    """GET one text payload (listing HTML, scripts) with retries."""

    def _action() -> str:
        req = request.Request(url, headers={"User-Agent": "ser-tpu-data/1.0", **(headers or {})})
        with request.urlopen(req, timeout=timeout_seconds) as response:  # noqa: S310
            return response.read().decode("utf-8", errors="replace")

    return run_with_retries(description=f"GET {url}", action=_action, retries=retries)


def compute_file_md5(path: Path, *, chunk_bytes: int = _CHUNK) -> str:
    """Streamed MD5 (upstream datasets publish md5, not sha256)."""
    digest = hashlib.md5()  # noqa: S324 - provider-published checksum format
    with path.open("rb") as handle:
        for chunk in iter(lambda: handle.read(chunk_bytes), b""):
            digest.update(chunk)
    return digest.hexdigest()


class TransportError(RuntimeError):
    """A network action failed (non-retryable status or exhausted retries)."""


class DownloadIntegrityError(ValueError):
    """A completed download failed its expected size or md5 check."""


def ensure_disk_space(destination: Path, required_bytes: int | None) -> None:
    """Fails fast when a known download size exceeds free space."""
    if required_bytes is None or required_bytes <= 0:
        return
    destination.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(destination.parent).free
    if free < required_bytes:
        raise RuntimeError(
            f"Download aborted: needs {required_bytes} bytes, {free} free at "
            f"{destination.parent}. Point --dataset-root at a larger volume."
        )


def download_file(
    url: str,
    destination: Path,
    *,
    expected_md5: str | None = None,
    expected_size: int | None = None,
    headers: dict[str, str] | None = None,
    retries: int = DEFAULT_RETRIES,
    timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
) -> Path:
    """Downloads one file atomically with retries and md5/size verification.

    Reuses :func:`downloads.fetch_url` (resumable ``.part`` staging, atomic
    rename, ``file://`` support) and layers the provider-published integrity
    contract on top: an existing valid destination short-circuits; a completed
    fetch that misses the expected size or md5 is deleted and raises.
    """
    destination.parent.mkdir(parents=True, exist_ok=True)
    if destination.is_file():
        size = destination.stat().st_size
        if expected_size is not None and size != expected_size:
            destination.unlink()
        elif expected_md5 is not None:
            if compute_file_md5(destination) == expected_md5:
                return destination
            destination.unlink()
        elif size > 0:
            return destination
        # Falling through means re-fetch (zero-byte file, or integrity
        # mismatch already unlinked). A still-existing destination would hit
        # fetch_url's destination-exists short-circuit and be returned
        # untouched — a 0-byte error-page download would then be permanent.
        destination.unlink(missing_ok=True)
    ensure_disk_space(destination, expected_size)

    run_with_retries(
        description=f"download {url}",
        action=lambda: fetch_url(
            url, destination, timeout_seconds=timeout_seconds, headers=headers
        ),
        retries=retries,
    )

    if expected_size is not None:
        actual = destination.stat().st_size
        if actual != expected_size:
            destination.unlink()
            raise DownloadIntegrityError(
                f"{destination.name}: size {actual} != expected {expected_size}."
            )
    if expected_md5 is not None:
        actual_md5 = compute_file_md5(destination)
        if actual_md5 != expected_md5:
            destination.unlink()
            raise DownloadIntegrityError(
                f"{destination.name}: md5 {actual_md5} != expected {expected_md5}."
            )
    return destination


@dataclass(frozen=True)
class ProviderTransport:
    """The IO seam every provider workflow runs through.

    Production uses the module defaults; tests inject fixture-backed
    callables (or ``file://`` URL rewrites) to drive complete acquisition
    workflows with zero egress.
    """

    request_json: Callable[..., object] = field(default=request_json)
    request_text: Callable[..., str] = field(default=request_text)
    download_file: Callable[..., Path] = field(default=download_file)


DEFAULT_TRANSPORT = ProviderTransport()


__all__ = [
    "DEFAULT_RETRIES",
    "DEFAULT_RETRY_BASE_SECONDS",
    "DEFAULT_TIMEOUT_SECONDS",
    "DEFAULT_TRANSPORT",
    "DownloadIntegrityError",
    "TransportError",
    "ProviderTransport",
    "compute_file_md5",
    "download_file",
    "ensure_disk_space",
    "is_retryable_http_status",
    "request_json",
    "request_text",
    "run_with_retries",
]
