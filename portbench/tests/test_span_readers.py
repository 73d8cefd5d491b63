"""The readers of the program's stage spans and encoder counters, on a synthetic trace.

``trace.summarize`` gets device intervals and host events that hold ``ser.*`` spans, with
torch ops inside and between them; each idle gap must be named by the innermost host event
over its middle, and the readers must return each stage's share of the window.
"""

from __future__ import annotations

import types

import pytest
import torch

from portbench.harness import spans, spec
from portbench.harness.readings import Context
from portbench.harness.trace import summarize
from ser_tpu_torch._internal.utils import profiling

US = 1_000  # ns
WINDOW = (0, 10000 * US)
HOST = [
    (0, 9500 * US, "ser.infer_many"),
    (100 * US, 1000 * US, "ser.decode"),
    (1000 * US, 2000 * US, "ser.resample"),
    (2000 * US, 3000 * US, "ser.encode"),
    (2100 * US, 2150 * US, "aten::mm"),
    (2400 * US, 2600 * US, "aten::addmm"),
    (3000 * US, 4000 * US, "ser.fetch"),
    (3000 * US, 3200 * US, "aten::copy_"),
    (4000 * US, 5000 * US, "ser.pool"),
    (5000 * US, 6000 * US, "ser.classify"),
    (5100 * US, 5120 * US, "aten::addmm"),
]
DEVICE = [
    (0, 100 * US, "k.before"),
    (1000 * US, 1010 * US, "k.a"),
    (2000 * US, 2010 * US, "k.b"),
    (2150 * US, 2400 * US, "k.encoder.1"),
    (2600 * US, 2900 * US, "k.encoder.2"),
    (3050 * US, 3200 * US, "Memcpy DtoH"),
    (4000 * US, 4010 * US, "k.c"),
    (5000 * US, 5010 * US, "k.d"),
    (5120 * US, 5200 * US, "k.head"),
    (6000 * US, 6010 * US, "k.e"),
    (9500 * US, 9510 * US, "k.f"),
]
#: Idle seconds each gap's middle gives its innermost host event (hand-worked from the lists above).
EXPECTED_IDLE = {
    "ser.decode": 0.90e-3,
    "ser.resample": 0.99e-3,
    "ser.encode": 0.14e-3 + 0.15e-3,
    "aten::addmm": 0.20e-3,
    "ser.fetch": 0.80e-3,
    "ser.pool": 0.99e-3,
    "ser.classify": 0.11e-3 + 0.80e-3,
    "ser.infer_many": 3.49e-3,
    spans.UNNAMED: 0.49e-3,
}
IDLE_READERS = {
    "idle_decode.batch": "ser.decode", "idle_resample.batch": "ser.resample", "idle_encode.batch": "ser.encode",
    "idle_fetch.batch": "ser.fetch", "idle_pool.batch": "ser.pool", "idle_classify.batch": "ser.classify",
    "idle_unnamed.batch": spans.UNNAMED,
}
COUNTER_READERS = ("encode_fill.batch", "encode_rows.batch")


def _context(trace) -> Context:
    return Context(config={}, traffic={}, corpus=None, records=[], window_s=10.0, setup_s=0.0, trace=trace)


def _read(name: str, ctx: Context):
    return spec.load_module("metrics", name).read(ctx)


@pytest.fixture
def summary():
    return summarize(list(DEVICE), list(HOST), *WINDOW)


def test_each_gap_is_named_by_its_innermost_span(summary):
    assert summary.idle_by_host == pytest.approx(EXPECTED_IDLE, abs=1e-12)
    assert summary.window_s == pytest.approx(0.01)


def test_idle_readers_split_the_idle_share(summary):
    ctx = _context(summary)
    shares = {name: _read(name, ctx) for name in IDLE_READERS}
    assert shares == pytest.approx({name: 100.0 * EXPECTED_IDLE[label] / 0.01 for name, label in IDLE_READERS.items()})
    assert shares["idle_unnamed.batch"] == pytest.approx(4.9)
    assert sum(shares.values()) <= _read("device_idle.batch", ctx)


def test_a_stage_with_no_gap_reads_zero_and_no_trace_reads_nothing(summary):
    without_pool = summarize(list(DEVICE), [h for h in HOST if h[2] != "ser.pool"], *WINDOW)
    assert _read("idle_pool.batch", _context(without_pool)) == 0.0
    for name in (*IDLE_READERS, *COUNTER_READERS):
        assert _read(name, _context(None)) is None


def test_a_program_without_spans_or_counters_reads_nothing(summary, monkeypatch):
    monkeypatch.setattr(spans, "profiling", types.SimpleNamespace())
    ctx = _context(summary)
    for name in (*IDLE_READERS, *COUNTER_READERS):
        assert (_read(name, ctx) is None) == (name != "idle_unnamed.batch"), name


def test_counter_readers_read_the_programs_counts(summary):
    ctx = _context(summary)
    profiling.reset_counts()
    try:
        for name in COUNTER_READERS:
            assert _read(name, ctx) is None
        profiling.count(encode_calls=4, encode_rows=4, encode_row_samples=4 * 480000)  # no profiler: not counted
        assert profiling.counts()["encode_calls"] == 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.count(encode_calls=2, encode_rows=9, encode_row_samples=9 * 480000,
                            encode_audio_samples=4_000_000)
        assert _read("encode_rows.batch", ctx) == 4.5
        assert _read("encode_fill.batch", ctx) == pytest.approx(100.0 * 4_000_000 / (9 * 480000))
    finally:
        profiling.reset_counts()
