"""The device trace of a ``--trace 1`` window: ``torch.profiler`` over CPU and CUDA.

Reads the raw events (no chrome trace is written): every device activity's interval,
and the host's torch ops, to say what the host was doing in each idle gap. A trace
stopped with ``TEARDOWN_CUPTI=1`` hangs at exit on the card's machine, so it is 0 here.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

#: Idle gaps shorter than this are counted in the idle share but not named.
NAMED_GAP_S = 20e-6
NAME_CHARS = 120
LOOK_BACK = 32


@dataclass
class TraceSummary:
    """What a traced window read: device intervals merged, seconds by kernel, idle by host label."""

    window_s: float
    busy_s: float
    by_kernel: dict[str, float]
    idle_by_host: dict[str, float]

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of the activities whose name holds any of ``fragments``."""
        return sum(s for name, s in self.by_kernel.items() if any(f in name for f in fragments))

    def breakdown(self) -> dict:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


class DeviceTrace:
    """``with DeviceTrace() as trace: ...`` then ``trace.summary()``."""

    def __enter__(self):
        os.environ["TEARDOWN_CUPTI"] = "0"
        from torch.profiler import ProfilerActivity, profile

        self._profile = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._profile.__enter__()
        self._start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._end_ns = time.time_ns()
        self._profile.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType

        device, host = [], []
        for event in self._profile.profiler.kineto_results.events():
            start = event.start_ns() if hasattr(event, "start_ns") else int(event.start_us() * 1000)
            length = event.duration_ns() if hasattr(event, "duration_ns") else int(event.duration_us() * 1000)
            row = (start, start + length, event.name())
            if event.device_type() == DeviceType.CUDA:
                device.append(row)
            elif event.device_type() == DeviceType.CPU:
                host.append(row)
        return summarize(device, host, self._start_ns, self._end_ns)


def summarize(device: list[tuple[int, int, str]], host: list[tuple[int, int, str]], start_ns: int,
              end_ns: int) -> TraceSummary:
    """Merges the device intervals and names each idle gap by the innermost host op over its middle."""
    by_kernel: dict[str, float] = defaultdict(float)
    for lo, hi, name in device:
        by_kernel[name] += (hi - lo) / 1e9
    window_s = (end_ns - start_ns) / 1e9
    if not device:
        return TraceSummary(window_s, 0.0, dict(by_kernel), {"no device activity": window_s})
    device.sort()
    starts = np.array([d[0] for d in device], dtype=np.int64)
    ends = np.maximum.accumulate(np.array([d[1] for d in device], dtype=np.int64))
    gap_lo = np.concatenate([[start_ns], ends])
    gap_hi = np.concatenate([starts, [end_ns]])
    gap = np.clip(gap_hi - gap_lo, 0, None)
    busy_s = window_s - gap.sum() / 1e9
    named = np.flatnonzero(gap >= NAMED_GAP_S * 1e9)
    middles = (gap_lo[named] + gap_hi[named]) // 2
    host.sort()
    host_starts = np.array([h[0] for h in host] or [0], dtype=np.int64)
    host_ends = np.array([h[1] for h in host] or [0], dtype=np.int64)
    # The latest-started host op that covers the gap's middle, among the last LOOK_BACK to start.
    found = np.full(named.size, -1)
    last = np.searchsorted(host_starts, middles, side="right") - 1
    for back in range(LOOK_BACK):
        j = last - back
        hit = (found < 0) & (j >= 0) & (host_ends[np.clip(j, 0, None)] >= middles)
        found[hit] = j[hit]
    idle_by_host: dict[str, float] = defaultdict(float)
    for i, j in zip(named, found):
        idle_by_host[host[j][2] if j >= 0 and host else "no torch op on the host"] += gap[i] / 1e9
    return TraceSummary(window_s, busy_s, dict(by_kernel), dict(idle_by_host))
