"""Resampling to the encoders' 16 kHz, written into their padded rows: kernel ``resample_rows``.

It replaces no TPU kernel. The JAX package resamples on the host
(``ser_tpu/_internal/utils/audio_io.py::resample_audio``: scipy's
``resample_poly`` in float64) and hands the encoder rows it lays out in
numpy. Here the source samples go to the card once, and one launch of
``csrc/resample.cu`` writes the rows: each row is a stretch of one clip's
``resample_poly(clip, up, down)`` followed by exact zeros. The semantics are
``resample_poly``'s defaults for any ratio: the same Kaiser FIR (computed here
in float64, once per ratio), the same alignment, zero extension at the clip's
ends and output length ``ceil(n · up / down)``. The kernel accumulates in
float32 (within about 1e-7 of the float64 result at audio levels).

A row descriptor is four int64 numbers: the clip's offset in the flat source,
its length at the source rate, the row's first output within the clip, and
the outputs the row holds (the rest of the row is zeros; 0 makes a padding
row). A CPU tensor takes the plain version, :func:`resample_rows_reference`:
the same polyphase sum in float64, cast to float32, which gives
``resample_poly``'s values to within a float32 rounding (it runs on the card
too, where it is what the kernel is checked against).
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch

from ser_tpu_torch.ops import kernel_build

#: Launches of ``resample_rows`` (its wrapper adds one per launch).
COUNTER = kernel_build.KernelCounter("resample_rows")
#: Fields of a row descriptor, in order.
ROW_FIELDS = ("offset", "length", "start", "valid")
#: (output, tap) products the plain version forms at once: its working memory, about 40 bytes each.
REFERENCE_BLOCK = 1 << 21


def ratio(orig_sr: int, target_sr: int) -> tuple[int, int]:
    """``(up, down)``: ``target_sr / orig_sr`` reduced by their gcd, as ``resample_poly`` reduces it."""
    if orig_sr <= 0 or target_sr <= 0:
        raise ValueError(f"Sample rates must be positive, got {orig_sr} and {target_sr}.")
    g = gcd(int(orig_sr), int(target_sr))
    return int(target_sr) // g, int(orig_sr) // g


def resampled_length(n_samples: int, up: int, down: int) -> int:
    """``len(resample_poly(x, up, down))`` for ``n_samples`` samples of ``x``: ``ceil(n · up / down)``."""
    return -(-int(n_samples) * up // down)


def half_length(up: int, down: int) -> int:
    """The filter's half length, ``10 · max(up, down)``; 0 at 1/1, where no filter runs."""
    return 0 if up == down == 1 else 10 * max(up, down)


@lru_cache(maxsize=16)
def filter_taps(up: int, down: int) -> np.ndarray:
    """``resample_poly``'s default filter in float64: ``firwin(2 · half + 1, 1 / max(up, down),
    window=("kaiser", 5.0)) · up``; the single tap 1 at 1/1 (a plain copy)."""
    if up == down == 1:
        return np.ones(1)
    from scipy.signal import firwin

    half = half_length(up, down)
    return firwin(2 * half + 1, 1.0 / max(up, down), window=("kaiser", 5.0)) * up


@lru_cache(maxsize=16)
def polyphase_table(up: int, down: int) -> np.ndarray:
    """``P`` (up, kt) float64: ``P[r, k] = h[r + up · k]``, zero past the filter's end; output
    ``i`` of a clip is ``sum_k P[r, k] · x[s_hi − k]``, ``s_hi, r = divmod(i · down + half, up)``."""
    taps = filter_taps(up, down)
    kt = -(-taps.size // up)
    padded = np.zeros(up * kt)
    padded[: taps.size] = taps
    return padded.reshape(kt, up).T.copy()


@lru_cache(maxsize=16)
def kernel_table(up: int, down: int) -> np.ndarray:
    """:func:`polyphase_table` as the kernel reads it, flat float32: each phase's row by tap class
    ``k % down``, then ``k // down``."""
    table = polyphase_table(up, down)
    kt = table.shape[1]
    order = np.concatenate([np.arange(rho, kt, down) for rho in range(min(down, kt))])
    return np.ascontiguousarray(table[:, order], dtype=np.float32).reshape(-1)


def row_descriptors(placements, row_samples: int, up: int, down: int, n_rows: int | None = None) -> np.ndarray:
    """(n_rows, 4) int64 descriptors from ``(offset, length, start, valid)`` placements, padding
    rows (all zero) after them up to ``n_rows``; raises where a row overruns its row or its clip."""
    placed = np.asarray(placements, dtype=np.int64).reshape(-1, len(ROW_FIELDS))
    rows = np.zeros((max(len(placed), n_rows or 0), len(ROW_FIELDS)), dtype=np.int64)
    rows[: len(placed)] = placed
    start, valid = rows[:, 2], rows[:, 3]
    if np.any(valid < 0) or np.any(valid > row_samples) or np.any(start < 0):
        raise ValueError("Row descriptors need 0 <= valid <= row_samples and start >= 0.")
    if np.any((valid > 0) & (start + valid > -(-rows[:, 1] * up // down))):
        raise ValueError("A row descriptor reaches past its clip's resampled end.")
    return rows


def resample_rows_reference(
    source: torch.Tensor, rows: torch.Tensor, up: int, down: int, row_samples: int
) -> torch.Tensor:
    """Plain version of ``resample_rows``, on ``source``'s device: the polyphase sum in float64 over
    every valid output, cast to float32. Outputs go in blocks of at most :data:`REFERENCE_BLOCK`
    (output, tap) products, a few whole-block operations each (not a handful per tap)."""
    device = source.device
    desc = rows.detach().to(device, torch.int64)
    out = torch.zeros((desc.shape[0], row_samples), dtype=torch.float32, device=device)
    valid = desc[:, 3]
    total = int(valid.sum())
    if total == 0:
        return out
    row_of = torch.repeat_interleave(torch.arange(desc.shape[0], device=device), valid, output_size=total)
    column = torch.arange(total, device=device) - torch.repeat_interleave(
        torch.cumsum(valid, 0) - valid, valid, output_size=total
    )
    table = torch.from_numpy(polyphase_table(up, down)).to(device)
    taps = torch.arange(table.shape[1], device=device)
    x = source.detach().to(torch.float64)
    block = max(1, REFERENCE_BLOCK // table.shape[1])
    for first in range(0, total, block):
        row, col = row_of[first : first + block], column[first : first + block]
        base = (desc[row, 2] + col) * down + half_length(up, down)
        s = (base // up)[:, None] - taps  # output's sample for each tap k: s_hi - k
        inside = (s >= 0) & (s < desc[row, 1, None])
        samples = torch.where(inside, x[desc[row, 0, None] + torch.where(inside, s, 0)], 0.0)
        out[row, col] = (samples * table[base % up]).sum(1).to(torch.float32)
    return out


_TABLES: dict[tuple, torch.Tensor] = {}


def _table_on(device: torch.device, up: int, down: int) -> torch.Tensor:
    """:func:`kernel_table` on ``device``, copied there once per ratio."""
    key = (device, up, down)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.from_numpy(kernel_table(up, down)).to(device)
    return table


def resample_rows(source: torch.Tensor, rows: torch.Tensor, up: int, down: int, row_samples: int) -> torch.Tensor:
    """Kernel ``resample_rows``: flat float32 ``source`` + (n_rows, 4) int64 ``rows`` → (n_rows, row_samples)
    float32, row b holding ``resample_poly(clip_b, up, down)[start_b : start_b + valid_b]`` then zeros.

    ``up``/``down`` reduced by their gcd (:func:`ratio`); the descriptors as :func:`row_descriptors`
    makes them. A CPU ``source`` and ``rows`` take :func:`resample_rows_reference`; on the card the
    kernel (``csrc/resample.cu``), which does not check the descriptors against the source.
    """
    if gcd(up, down) != 1 or up <= 0 or down <= 0:
        raise ValueError(f"resample_rows takes a reduced ratio, not {up}/{down}.")
    if source.dim() != 1 or rows.dim() != 2 or rows.shape[1] != len(ROW_FIELDS) or rows.shape[0] < 1:
        raise ValueError(f"Bad shapes: source {tuple(source.shape)}, rows {tuple(rows.shape)}.")
    if row_samples < 1:
        raise ValueError(f"row_samples must be positive, got {row_samples}.")
    if source.dtype != torch.float32 or rows.dtype != torch.int64:
        raise TypeError("resample_rows takes a float32 source and int64 rows.")
    if source.device.type == "cpu" and rows.device.type == "cpu":
        return resample_rows_reference(source, rows, up, down, row_samples)
    if source.device.type != "cuda" or rows.device != source.device:
        raise ValueError("resample_rows takes source and rows on one CUDA device.")
    if not (source.is_contiguous() and rows.is_contiguous()):
        raise ValueError("resample_rows takes contiguous tensors.")
    kernel_build.refuse_grad("resample_rows", source)
    entry = kernel_build.load("resample_rows")
    table = _table_on(source.device, up, down)
    out = torch.empty((rows.shape[0], row_samples), dtype=torch.float32, device=source.device)
    stream = torch.cuda.current_stream(source.device).cuda_stream
    code = entry(
        source.data_ptr(), rows.data_ptr(), table.data_ptr(), out.data_ptr(), rows.shape[0], row_samples, up, down,
        half_length(up, down), polyphase_table(up, down).shape[1], stream,
    )
    kernel_build.check(code, "resample_rows")
    COUNTER.launches += 1
    return out


__all__ = [
    "COUNTER",
    "REFERENCE_BLOCK",
    "ROW_FIELDS",
    "filter_taps",
    "half_length",
    "kernel_table",
    "polyphase_table",
    "ratio",
    "resample_rows",
    "resample_rows_reference",
    "resampled_length",
    "row_descriptors",
]
