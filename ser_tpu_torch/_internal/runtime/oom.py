"""Device out-of-memory recognition and parsing.

Counterpart of ``ser_tpu/_internal/runtime/oom.py``: whether an error is a
device memory exhaustion, and the requested, available and limit byte
figures its message carries (``DeviceOomInfo``, the JAX package's fields).
The port's device is the CUDA card: ``torch.cuda.OutOfMemoryError`` and
CUDA's messages ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a
total capacity of 79.19 GiB of which 1.20 GiB is free.", "CUBLAS_STATUS_ALLOC_FAILED",
cudaErrorMemoryAllocation's "out of memory") count, beside the XLA shapes the
JAX package parses, so a report written by either package reads the same.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

_UNITS = {"b": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}

#: Size token: "8589934592 bytes", "16.6G", "15.48GiB", "2.1 MB", "2.00 GiB".
_SIZE = r"([0-9]+(?:\.[0-9]+)?)\s*([KMGTkmgt]i?[Bb]?|[Bb]ytes?|[Bb])"
_PATTERNS: tuple[tuple[str, str], ...] = (
    (rf"[Aa]llocat(?:ing|e)\s+{_SIZE}", "requested"),
    (rf"requested\s*[:=]?\s*{_SIZE}", "requested"),
    (rf"free\s*[:=]?\s*{_SIZE}", "available"),
    (rf"{_SIZE}\s+(?:is\s+)?free", "available"),
    (rf"available\s*[:=]?\s*{_SIZE}", "available"),
    (rf"limit\s*[:=]?\s*{_SIZE}", "limit"),
    (rf"total capacity of\s+{_SIZE}", "limit"),
    (rf"[Uu]sed\s+{_SIZE}\s+of\s+{_SIZE}", "used_of_limit"),
)


@dataclass(frozen=True)
class DeviceOomInfo:
    """Parsed figures from one OOM message (bytes; None when absent)."""

    requested_bytes: int | None = None
    available_bytes: int | None = None
    limit_bytes: int | None = None

    @property
    def is_informative(self) -> bool:
        return any(value is not None for value in (self.requested_bytes, self.available_bytes, self.limit_bytes))


def _to_bytes(value: str, unit: str) -> int:
    head = unit[0].lower() if unit else "b"
    return int(float(value) * _UNITS.get(head, 1))


def is_device_oom(error: BaseException | str) -> bool:
    """True when an error (or its message) is a device memory exhaustion."""
    if isinstance(error, torch.cuda.OutOfMemoryError):
        return True
    # \bOOM\b, not a bare substring: 'ROOM_101.wav' in an unrelated error is no OOM.
    return bool(
        re.search(
            r"RESOURCE_EXHAUSTED|out of memory|\bOOM\b|exceeded hbm capacity|failed to allocate"
            r"|CUBLAS_STATUS_ALLOC_FAILED",
            str(error),
            re.IGNORECASE,
        )
    )


def parse_device_oom(error: BaseException | str) -> DeviceOomInfo:
    """Extracts byte figures from one OOM message."""
    text = str(error)
    found: dict[str, int] = {}
    for pattern, kind in _PATTERNS:
        if kind == "used_of_limit":
            match = re.search(pattern, text)
            if match and "limit" not in found:
                found["limit"] = _to_bytes(match.group(3), match.group(4))
            continue
        if kind in found:
            continue
        match = re.search(pattern, text)
        if match:
            found[kind] = _to_bytes(match.group(1), match.group(2))
    return DeviceOomInfo(
        requested_bytes=found.get("requested"),
        available_bytes=found.get("available"),
        limit_bytes=found.get("limit"),
    )


__all__ = ["DeviceOomInfo", "is_device_oom", "parse_device_oom"]
