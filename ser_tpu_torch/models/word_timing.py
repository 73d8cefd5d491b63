"""Cross-attention DTW word timing (host-side, numpy).

Counterpart of ``ser_tpu/models/word_timing.py``: turns the alignment-head
attention captured during the KV-cache decode into per-word start/end seconds
(normalize → standardize across tokens → median filter → head average → DTW
over the audio axis → token jump times → BPE-token → word merge, with the
published punctuation merge). The DTW runs in the port's native C++ library
(``_internal/utils/native_audio.py``) when it builds, else in numpy; both
compute the same path.
"""

from __future__ import annotations

import string
from dataclasses import dataclass

import numpy as np

#: Seconds per encoder output frame (two 160-sample mel hops at 16 kHz).
TIME_PER_FRAME = 0.02

_PREPEND_PUNCT = "\"'“¿([{-"
_APPEND_PUNCT = "\"'.。,，!！?？:：”)]}、"


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding (odd width).

    Skips only when the axis cannot support the reflect pad (length <=
    width//2) — the published behavior (openai whisper ``timing.py``), so
    short post-VAD chunks filter identically to the reference stack.
    """
    if width < 3 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path minimizing summed cost over (rows, cols).

    Moves: diagonal, down (next row, same col), right (same row, next col).
    Returns (row_indices, col_indices) from (0, 0) to (N-1, M-1).

    Dispatches to the native C++ dynamic program (one row-major pass,
    ``ser_tpu_torch/native/seraudio.cpp::ser_dtw_path``) when the library is
    available; the numpy fallback below is vectorized over anti-diagonals
    (cells on diagonal ``i+j`` depend only on the two previous diagonals) and
    computes the identical path.
    """
    native = _native_dtw_path(cost)
    if native is not None:
        return native
    n_rows, n_cols = cost.shape
    total = np.full((n_rows + 1, n_cols + 1), np.inf, dtype=np.float64)
    total[0, 0] = 0.0
    # 0 = diagonal (i-1, j-1), 1 = down (i-1, j), 2 = right (i, j-1)
    trace = np.zeros((n_rows + 1, n_cols + 1), dtype=np.int8)

    for diag in range(2, n_rows + n_cols + 1):
        lo = max(1, diag - n_cols)
        hi = min(n_rows, diag - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = diag - i
        candidates = np.stack(
            [total[i - 1, j - 1], total[i - 1, j], total[i, j - 1]]
        )
        choice = np.argmin(candidates, axis=0)
        total[i, j] = cost[i - 1, j - 1] + candidates[choice, np.arange(i.size)]
        trace[i, j] = choice

    rows: list[int] = []
    cols: list[int] = []
    i, j = n_rows, n_cols
    while i > 0 and j > 0:
        rows.append(i - 1)
        cols.append(j - 1)
        move = trace[i, j]
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(rows[::-1]), np.asarray(cols[::-1])


def _native_dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """C++ DTW via ctypes; None when the native library is unavailable."""
    from ser_tpu_torch._internal.utils.native_audio import get_native_library

    library = get_native_library()
    if library is None:
        return None
    import ctypes

    matrix = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = matrix.shape
    out_rows = np.empty(n_rows + n_cols, dtype=np.int32)
    out_cols = np.empty(n_rows + n_cols, dtype=np.int32)
    out_len = ctypes.c_int64()
    code = library.ser_dtw_path(
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows,
        n_cols,
        out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(out_len),
    )
    if code != 0:
        return None
    length = out_len.value
    return out_rows[:length].astype(np.int64), out_cols[:length].astype(np.int64)


@dataclass(frozen=True)
class TimedWord:
    """One merged word with aligned bounds in chunk-relative seconds."""

    word: str
    start: float
    end: float


def _split_tokens_on_unicode(token_ids: list[int], tokenizer):
    """Greedy split at the smallest decodable (no replacement char) pieces.

    A piece CONTAINING the replacement char still flushes when the full
    decode carries a genuine U+FFFD at the same offset (published
    split_tokens_on_unicode fallback) — otherwise one legitimate
    replacement char in the transcript makes every later token accumulate
    into a single trailing piece with one start/end time.
    """
    replacement = "�"
    decoded_full = tokenizer.decode(token_ids)
    pieces: list[str] = []
    piece_spans: list[tuple[int, int]] = []
    pending: list[int] = []
    start = 0
    unicode_offset = 0
    for index, token_id in enumerate(token_ids):
        pending.append(token_id)
        decoded = tokenizer.decode(pending)
        flush = decoded and replacement not in decoded
        if not flush and decoded:
            at = unicode_offset + decoded.index(replacement)
            flush = decoded_full[at : at + 1] == replacement
        if flush:
            pieces.append(decoded)
            piece_spans.append((start, index + 1))
            pending = []
            start = index + 1
            unicode_offset += len(decoded)
    if pending:
        pieces.append(tokenizer.decode(pending))
        piece_spans.append((start, len(token_ids)))
    return pieces, piece_spans


def split_tokens_into_words(token_ids: list[int], tokenizer):
    """Groups BPE tokens into display words (space/punctuation boundaries).

    Returns (words, spans) where spans index into ``token_ids``.
    """
    pieces, piece_spans = _split_tokens_on_unicode(token_ids, tokenizer)
    words: list[str] = []
    spans: list[tuple[int, int]] = []
    for piece, (lo, hi) in zip(pieces, piece_spans):
        boundary = (
            not words
            or piece.startswith(" ")
            or piece.strip() in string.punctuation
        )
        if boundary:
            words.append(piece)
            spans.append((lo, hi))
        else:
            words[-1] += piece
            spans[-1] = (spans[-1][0], hi)
    return words, spans


def _merge_punctuation(words, starts, ends):
    """Folds openers into the next word, closers into the previous.

    Published ``merge_punctuations`` semantics (openai whisper timing.py,
    the behavior the reference inherits through stable-ts): the PREPEND pass
    runs first, walking backwards, gated on the opener being space-prefixed
    (``' "'`` attaches to the following word; a bare ``'"'`` mid-word does
    not); the APPEND pass walks forwards, gated on the previous word not
    ending with a space and the candidate being exactly a closer. Timing
    fields are left untouched — a merged-away entry's times are discarded,
    so ``'"hello'`` keeps hello's start (NOT the quote's).
    """
    entries: list[list] = [[w, s, e] for w, s, e in zip(words, starts, ends)]
    i, j = len(entries) - 2, len(entries) - 1
    while i >= 0:
        prev, following = entries[i], entries[j]
        if prev[0].startswith(" ") and prev[0].strip() in _PREPEND_PUNCT and prev[0].strip():
            following[0] = prev[0] + following[0]
            prev[0] = ""
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(entries):
        prev, following = entries[i], entries[j]
        if not prev[0].endswith(" ") and following[0] in _APPEND_PUNCT and following[0]:
            prev[0] = prev[0] + following[0]
            following[0] = ""
        else:
            i = j
        j += 1
    return [entry for entry in entries if entry[0]]


def word_timings_from_alignment(
    attention: np.ndarray,
    token_ids: list[int],
    tokenizer,
    *,
    num_frames: int,
    timestamp_begin: int,
    medfilt_width: int = 7,
) -> list[TimedWord]:
    """Aligns decoded tokens to audio frames and emits timed words.

    Args:
      attention: ``(n_align_heads, n_tokens, n_enc_frames)`` cross-attention
        probabilities, row t recorded while token t was the decoder input.
      token_ids: the emitted ids matching attention rows (may include
        timestamp tokens, which are excluded from alignment and output).
      num_frames: encoder frames actually covered by audio (pad cropped).
      timestamp_begin: first timestamp token id.
    """
    token_ids = list(token_ids)
    if not token_ids or attention.size == 0:
        return []
    num_frames = max(1, min(num_frames, attention.shape[-1]))

    weights = attention[:, :, :num_frames].astype(np.float64)
    weights /= weights.sum(axis=-1, keepdims=True) + 1e-12
    mean = weights.mean(axis=-2, keepdims=True)
    std = weights.std(axis=-2, keepdims=True)
    weights = (weights - mean) / (std + 1e-9)
    weights = median_filter(weights, medfilt_width)
    matrix = weights.mean(axis=0)  # (n_tokens, num_frames)
    return word_timings_from_matrix(
        matrix, token_ids, tokenizer, timestamp_begin=timestamp_begin
    )


def word_timings_from_matrix(
    matrix: np.ndarray,
    token_ids: list[int],
    tokenizer,
    *,
    timestamp_begin: int,
) -> list[TimedWord]:
    """DTW + word merge over a precomputed ``(n_tokens, num_frames)`` matrix.

    The matrix is the head-averaged, standardized, median-filtered attention
    — computed either host-side (:func:`word_timings_from_alignment`) or on
    device (``whisper_decode.reduce_alignment_matrix``, which avoids moving
    the per-head capture buffer off the accelerator).
    """
    token_ids = list(token_ids)
    text_rows = [i for i, t in enumerate(token_ids) if t < timestamp_begin]
    if not text_rows or matrix.size == 0:
        return []
    matrix = np.asarray(matrix, dtype=np.float64)[text_rows]

    row_path, col_path = dtw_path(-matrix)
    n_text = len(text_rows)
    starts = np.zeros(n_text)
    ends = np.zeros(n_text)
    boundaries = np.flatnonzero(np.diff(row_path, prepend=-1) > 0)
    for rank, path_index in enumerate(boundaries):
        starts[rank] = col_path[path_index] * TIME_PER_FRAME
        if rank > 0:
            ends[rank - 1] = col_path[path_index] * TIME_PER_FRAME
    ends[-1] = (col_path[-1] + 1) * TIME_PER_FRAME

    text_tokens = [token_ids[i] for i in text_rows]
    words, spans = split_tokens_into_words(text_tokens, tokenizer)
    word_starts = [float(starts[lo]) for lo, _ in spans]
    word_ends = [float(ends[hi - 1]) for _, hi in spans]
    merged = _merge_punctuation(words, word_starts, word_ends)

    timed: list[TimedWord] = []
    previous_start = 0.0
    for word, start, end in merged:
        text = word.strip()
        if not text:
            continue
        start = max(start, previous_start)  # DTW is monotonic; clamp for safety
        end = max(end, start + TIME_PER_FRAME)
        timed.append(TimedWord(word=text, start=start, end=end))
        previous_start = start
    return timed


__all__ = [
    "TIME_PER_FRAME",
    "TimedWord",
    "dtw_path",
    "median_filter",
    "split_tokens_into_words",
    "word_timings_from_alignment",
    "word_timings_from_matrix",
]
