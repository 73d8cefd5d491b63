"""What the program's own stage spans and encoder counters read in a ``--trace 1`` window.

The program names its host stages as spans on the profiler's clock (``ser.decode``,
``ser.resample``, ``ser.encode``, ``ser.fetch``, ``ser.pool``, ``ser.classify``), so the
trace names each idle gap of the card by the innermost stage over its middle; and while a
profiler records it counts its encoder's calls, rows and samples
(``ser_tpu_torch/_internal/utils/profiling.py``: ``span``, ``counts``). A process is
traced once, so the counts are the window's. A program without them reads nothing here.
"""

from __future__ import annotations

from ser_tpu_torch._internal.utils import profiling

#: The label ``trace.summarize`` gives an idle gap that no host event covers.
UNNAMED = "no torch op on the host"


def unnamed_share(ctx) -> float | None:
    """100 x the idle seconds of the gaps no host event names over the window; 0 where none
    was. None without a trace or without device activity."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_by_host.get(UNNAMED, 0.0) / ctx.trace.window_s


def idle_share(ctx, span: str) -> float | None:
    """100 x the idle seconds of the gaps named by the program's span ``span`` over the
    window; 0 where none was. None as :func:`unnamed_share`, or where the program marks
    no spans."""
    if not callable(getattr(profiling, "span", None)) or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_by_host.get(span, 0.0) / ctx.trace.window_s


def encode_counts(ctx) -> dict[str, int] | None:
    """The program's encoder counters over the traced window; None without a trace, without
    the counters, or where no encoder call was counted."""
    read = getattr(profiling, "counts", None)
    if ctx.trace is None or not callable(read):
        return None
    counts = read()
    return counts if counts.get("encode_calls") else None
