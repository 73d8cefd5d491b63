"""The two private torch names that ``ser_tpu_torch/_internal/utils/profiling.py::span`` rests on.

``torch.autograd._profiler_enabled`` (does a profiler record on this thread) and
``torch._C._profiler._RecordFunctionFast`` (a function-scope host event on the profiler's
clock) are imported when the port is. This file imports only torch, so a torch that renames
or changes either fails here by name, beside the import errors of the port's own tests.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity


def test_the_private_profiler_names_span_rests_on():
    enabled = getattr(torch.autograd, "_profiler_enabled", None)
    record = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
    assert callable(enabled), "torch.autograd._profiler_enabled is gone"
    assert callable(record), "torch._C._profiler._RecordFunctionFast is gone"
    assert enabled() is False
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as traced:
        assert enabled() is True
        with record("ser.probe"):
            torch.ones(8).sum()
    assert [event.name for event in traced.events()].count("ser.probe") == 1
