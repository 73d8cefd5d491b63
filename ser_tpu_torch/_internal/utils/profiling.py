"""Device-level tracing helpers over ``torch.profiler``.

Counterpart of ``ser_tpu/_internal/utils/profiling.py`` (which wraps
``jax.profiler``): :func:`device_trace` records the enclosed region with
``torch.profiler`` (CPU activity, and CUDA activity when a card is present)
and writes a Chrome trace, ``trace.json``, into the directory it is given
(open it in ui.perfetto.dev or ``chrome://tracing``).

:func:`span` names a host-side stage of the program inside any
``torch.profiler`` trace, and :func:`count` adds to the program's counters.
Both act only while a profiler records on the calling thread; otherwise they
cost one flag check. A span is a host event on the profiler's clock, so it
lies beside the device activity it launched, and an idle stretch of the card
under a span belongs to that stage. Spans nest by time. A span opens on the
thread that drives the card: a profiler does not see the events of a pool's
worker threads.
"""

from __future__ import annotations

import threading
from collections.abc import Iterator
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

#: The file :func:`device_trace` writes into its directory.
TRACE_FILE_NAME = "trace.json"

#: The counters :func:`count` keeps: encoder forward calls (a float32 retry
#: included), their rows (padding rows included), the 16 kHz samples those
#: rows hold with their padding, and the samples of audio in them; and the
#: 16 kHz samples that the encoders' row layout made on the card and on the
#: host (``encoder_backend.StagedClips.rows``).
COUNTER_NAMES = (
    "encode_calls",
    "encode_rows",
    "encode_row_samples",
    "encode_audio_samples",
    "resample_card_samples",
    "resample_host_samples",
)

_OFF = nullcontext()
#: A host event of the profiler's own function scope. ``record_function``'s user
#: scope would also put a device-side event over the kernels the span launched,
#: which covers the card's idle gaps between them and reads as busy time.
_enter = torch._C._profiler._RecordFunctionFast
_counts = dict.fromkeys(COUNTER_NAMES, 0)
_counts_lock = threading.Lock()


def span(name: str):
    """A context that marks ``name`` on the trace while a profiler records, else a shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _enter(name)


def count(**amounts: int) -> None:
    """Adds ``amounts`` to the counters while a profiler records on this thread."""
    if not _profiler_enabled():
        return
    with _counts_lock:
        for name, amount in amounts.items():
            _counts[name] += int(amount)


def counts() -> dict[str, int]:
    """A copy of the counters: what the traced regions since the last reset counted."""
    with _counts_lock:
        return dict(_counts)


def reset_counts() -> None:
    with _counts_lock:
        _counts.update(dict.fromkeys(COUNTER_NAMES, 0))


@contextmanager
def device_trace(trace_dir: str | Path) -> Iterator[None]:
    """Captures a ``torch.profiler`` trace of the enclosed region into ``trace_dir/trace.json``,
    and logs the counters the region counted."""
    target = Path(trace_dir)
    target.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    reset_counts()
    profiler.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(str(target / TRACE_FILE_NAME))
        logger.info("Device trace written to %s; counters %s", target / TRACE_FILE_NAME, counts())


__all__ = ["COUNTER_NAMES", "TRACE_FILE_NAME", "count", "counts", "device_trace", "reset_counts", "span"]
