"""Local latency benchmark harness.

Counterpart of ``ser_tpu/_internal/runtime/benchmarks.py``: repeated
predictions over one file with mean/median/p95 latency (nearest-rank p95)
reported as JSON. ``benchmark_fast_predict`` times the fast profile's
prediction on the settings' device: the card unless the settings ask for the
CPU.
"""


from __future__ import annotations

import json
import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LatencyReport:
    """Latency summary over repeated runs."""

    runs: int
    mean_seconds: float
    median_seconds: float
    p95_seconds: float
    min_seconds: float
    max_seconds: float

    def to_json(self) -> str:
        return json.dumps(
            {
                "runs": self.runs,
                "mean_seconds": round(self.mean_seconds, 4),
                "median_seconds": round(self.median_seconds, 4),
                "p95_seconds": round(self.p95_seconds, 4),
                "min_seconds": round(self.min_seconds, 4),
                "max_seconds": round(self.max_seconds, 4),
            }
        )


def run_latency_benchmark(
    operation: Callable[[], object],
    *,
    runs: int = 5,
    warmup_runs: int = 1,
) -> LatencyReport:
    """Times ``operation`` ``runs`` times after ``warmup_runs`` untimed calls (first-call setup excluded)."""
    if runs < 1:
        raise ValueError("runs must be >= 1.")
    for _ in range(warmup_runs):
        operation()
    samples = []
    for _ in range(runs):
        start = time.perf_counter()
        operation()
        samples.append(time.perf_counter() - start)
    arr = np.asarray(samples)
    ordered = np.sort(arr)
    # Nearest-rank p95 (NOT interpolated: with 5 runs it is the max, which
    # np.percentile would not give).
    p95_index = min(len(ordered) - 1, int(round(0.95 * float(len(ordered) - 1))))
    return LatencyReport(
        runs=runs,
        mean_seconds=float(arr.mean()),
        median_seconds=float(np.median(arr)),
        p95_seconds=float(ordered[p95_index]),
        min_seconds=float(ordered[0]),
        max_seconds=float(ordered[-1]),
    )


def benchmark_fast_predict(
    file_path: str, *, runs: int = 5, settings=None
) -> LatencyReport:
    """Benchmarks fast-profile prediction latency on one file (the head loaded once, outside the timing)."""
    from ser_tpu_torch._internal.models.emotion_model import load_model, predict_emotions_detailed

    loaded = load_model(settings=settings, profile="fast")
    return run_latency_benchmark(
        lambda: predict_emotions_detailed(file_path, settings=settings, loaded=loaded),
        runs=runs,
    )


__all__ = ["LatencyReport", "benchmark_fast_predict", "run_latency_benchmark"]
