"""The closed loop: one caller, each call sent when the last returned.

The window runs whole cycles of calls over the corpus: calls start until ``seconds`` have
passed since the first and the calls made cover the corpus a whole number of times, and
the window ends when the last of them returns. So every call in it is complete and its
time all counted, and every seed's window asks the same work (each file equally often),
whichever files the seed put together in a call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class CallRecord:
    """One call: its files, host-clock start and end, each file's result (None: failed)."""

    files: list[int]
    started: float
    ended: float
    results: list
    phases: dict[str, float] = field(default_factory=dict)
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.ended - self.started


def run_window(driver, plan, seconds: float, cycle: int, synchronize) -> tuple[list[CallRecord], float]:
    """Calls ``driver`` on the plan's batches for ``seconds``, in whole cycles of ``cycle`` calls;
    (records, window seconds)."""
    records = []
    started = time.perf_counter()
    while time.perf_counter() - started < seconds or len(records) % cycle:
        records.append(driver.call(next(plan)))
    synchronize()
    return records, time.perf_counter() - started
