"""What the metric readers read: one run's window, and the yardstick applied to its inputs.

A reader (``metrics/<name>.py``) defines ``read(ctx) -> float | None``; None means it
found nothing to read in this run, and the metric is left out of the line.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

from portbench.harness import yardstick as ys


@dataclass
class Context:
    """One run: the cell, its corpus, the window's call records, and what was measured."""

    config: dict
    traffic: dict
    corpus: object
    records: list
    window_s: float
    setup_s: float
    peak_bytes: int | None = None
    trace: object | None = None

    def completed(self) -> list[int]:
        """File indices of the window's completed answers, one entry per answer."""
        return [f for r in self.records for f, result in zip(r.files, r.results) if result is not None]

    def samples_16k(self, index: int) -> int:
        return ys.resampled_length(self.corpus.samples[index], self.corpus.sample_rate)


def audio_seconds_per_second(ctx: Context) -> float:
    return sum(ctx.corpus.seconds(i) for i in ctx.completed()) / ctx.window_s


def latency_quantile(ctx: Context, q: int) -> float | None:
    """The q-th percentile of every request's latency in the window (``statistics.quantiles``)."""
    latencies = [r.latency for r in ctx.records]
    if len(latencies) < 2:
        return None
    return statistics.quantiles(latencies, n=100, method="inclusive")[q - 1]


def mean_phase(ctx: Context, phase: str, minus: str | None = None) -> float | None:
    """Mean over the window's requests of one phase's seconds (less another's)."""
    values = [r.phases[phase] - (r.phases[minus] if minus else 0.0) for r in ctx.records if phase in r.phases]
    return sum(values) / len(values) if values else None


def _valid_chunks(ctx: Context, index: int) -> list[int]:
    return [n for n in ys.wav2vec2_chunks(ctx.samples_16k(index), 30) if ys.wav2vec2_frames(ctx.config, n) > 0]


def model_flops(ctx: Context) -> float:
    """FLOP the completed answers' inputs need: every 30 s window a Whisper file needs, or
    each wav2vec2 chunk's valid samples."""
    total = 0.0
    for index in ctx.completed():
        if ctx.config["family"] == "wav2vec2":
            total += sum(ys.wav2vec2_chunk_flops(ctx.config, n) for n in _valid_chunks(ctx, index))
        else:
            total += ys.whisper_windows(ctx.samples_16k(index)) * ys.whisper_window_flops(ctx.config)
    return total


def mfu(ctx: Context) -> float:
    """Model FLOPs over the window's seconds at the card's bf16 peak, in %."""
    return 100.0 * model_flops(ctx) / (ctx.window_s * ys.PEAK_BF16_FLOPS)


def attention_bound_s(ctx: Context) -> float:
    """Least time of all the window's encoder self-attention, over valid keys and queries."""
    flops = moved = 0.0
    for index in ctx.completed():
        if ctx.config["family"] == "wav2vec2":
            heads, dim = ctx.config["num_attention_heads"], ctx.config["hidden_size"]
            layers = ctx.config["num_hidden_layers"]
            calls = [(1, ys.wav2vec2_frames(ctx.config, n)) for n in _valid_chunks(ctx, index)]
        else:
            heads, dim = ctx.config["encoder_attention_heads"], ctx.config["d_model"]
            layers = ctx.config["encoder_layers"]
            calls = [(ys.whisper_windows(ctx.samples_16k(index)), ys.WHISPER_STATES)]
        for batch, frames in calls:
            f, b = ys.attention_work(batch, heads, frames, frames, dim // heads)
            flops, moved = flops + layers * f, moved + layers * b
    return ys.bound_seconds(flops, moved, ys.PEAK_BF16_FLOPS)


def k1_bound_s(ctx: Context) -> float:
    """Least time of the window's K1 work: one launch a file, over its 30 s windows."""
    flops = moved = 0.0
    for index in ctx.completed():
        f, b = ys.k1_work(ys.whisper_windows(ctx.samples_16k(index)))
        flops, moved = flops + f, moved + b
    return ys.bound_seconds(flops, moved, ys.PEAK_TF32_FLOPS)


def roofline(ctx: Context, bound_s: float, *kernels: str) -> float | None:
    """100 x the bound over the device seconds of the kernels named; None when none ran."""
    if ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(*kernels)
    return 100.0 * bound_s / spent if spent > 0 else None


def idle_share(ctx: Context) -> float | None:
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
