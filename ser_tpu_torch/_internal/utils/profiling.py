"""Device-level tracing helpers over ``torch.profiler``.

Counterpart of ``ser_tpu/_internal/utils/profiling.py`` (which wraps
``jax.profiler``): :func:`device_trace` records the enclosed region with
``torch.profiler`` (CPU activity, and CUDA activity when a card is present)
and writes a Chrome trace, ``trace.json``, into the directory it is given
(open it in ui.perfetto.dev or ``chrome://tracing``); :func:`annotate` names a
host-side span inside the trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

from collections.abc import Iterator
from contextlib import contextmanager
from pathlib import Path

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

#: The file :func:`device_trace` writes into its directory.
TRACE_FILE_NAME = "trace.json"


@contextmanager
def device_trace(trace_dir: str | Path) -> Iterator[None]:
    """Captures a ``torch.profiler`` trace of the enclosed region into ``trace_dir/trace.json``."""
    import torch

    target = Path(trace_dir)
    target.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(str(target / TRACE_FILE_NAME))
        logger.info("Device trace written to %s", target / TRACE_FILE_NAME)


def annotate(name: str):
    """Named trace annotation for host-side phases inside a device trace."""
    import torch

    return torch.profiler.record_function(name)


__all__ = ["TRACE_FILE_NAME", "annotate", "device_trace"]
