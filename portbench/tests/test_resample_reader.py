"""The reader of the program's resampling counters, ``resample_on_card.batch``, on a synthetic trace.

It reads the share of the 16 kHz samples that the encoders' row layout made on the card; a window
without a trace, a program without the counters (the one before them) and a window with no row
laid out read nothing.
"""

from __future__ import annotations

import torch

from portbench.harness import spec
from portbench.harness.readings import Context
from portbench.harness.trace import summarize
from ser_tpu_torch._internal.utils import profiling

NAME = "resample_on_card.batch"
US = 1_000  # ns


def _context(trace) -> Context:
    return Context(config={}, traffic={}, corpus=None, records=[], window_s=1.0, setup_s=0.0, trace=trace)


def _read(ctx: Context):
    return spec.load_module("metrics", NAME).read(ctx)


def _summary():
    return summarize([(0, 10 * US, "k.a")], [(0, 20 * US, "ser.resample")], 0, 100 * US)


def test_reads_the_share_made_on_the_card():
    ctx = _context(_summary())
    profiling.reset_counts()
    try:
        assert _read(ctx) is None  # nothing laid out yet
        profiling.count(resample_card_samples=100)  # no profiler: not counted
        assert _read(ctx) is None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.count(resample_card_samples=3 * 480000)
            profiling.count(resample_host_samples=480000)
        assert _read(ctx) == 75.0
        assert _read(_context(None)) is None
    finally:
        profiling.reset_counts()


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    ctx = _context(_summary())
    monkeypatch.setattr(profiling, "counts", lambda: {"encode_calls": 2, "encode_rows": 9})
    assert _read(ctx) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read(ctx) is None
