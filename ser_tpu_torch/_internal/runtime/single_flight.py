"""Reference-counted keyed locks that serialize work on the same model.

Counterpart of ``ser_tpu/_internal/runtime/single_flight.py``: one re-entrant
lock per key (the boundaries use ``(profile, model_key)``), created on first
use and dropped when its last holder or waiter leaves, so the registry does
not grow. A thread that already holds a key may acquire it again.
"""

from __future__ import annotations

import threading
from collections.abc import Iterator
from contextlib import contextmanager


class SingleFlightRegistry:
    """Keyed re-entrant locks with reference counts."""

    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._locks: dict[tuple[str, ...], tuple[threading.RLock, int]] = {}

    @contextmanager
    def acquire(self, *key_parts: str) -> Iterator[None]:
        """Holds the lock of ``key_parts`` for the scope; callers of the same key take turns."""
        key = tuple(key_parts)
        with self._guard:
            lock, count = self._locks.get(key, (threading.RLock(), 0))
            self._locks[key] = (lock, count + 1)
        try:
            # Inside the try: an interrupt while blocked here must still drop the count.
            lock.acquire()
            try:
                yield
            finally:
                lock.release()
        finally:
            with self._guard:
                lock, count = self._locks[key]
                if count <= 1:
                    del self._locks[key]
                else:
                    self._locks[key] = (lock, count - 1)

    def active_keys(self) -> list[tuple[str, ...]]:
        """Keys currently held or waited for."""
        with self._guard:
            return list(self._locks)


#: The process-wide registry of the profile boundaries.
GLOBAL_SINGLE_FLIGHT = SingleFlightRegistry()

__all__ = ["GLOBAL_SINGLE_FLIGHT", "SingleFlightRegistry"]
