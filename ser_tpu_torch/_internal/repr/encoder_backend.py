"""Shared machinery of the encoder backends: weight resolution, chunking and batching.

Counterpart of ``ser_tpu/_internal/repr/encoder_backend.py``: the
per-(backend, model) random-init seed, the local HF-cache lookup, and the
chunked encode of the wav2vec2-class backends. A clip is cut into chunks of
at most 30 s; all its chunks form one batched call, padded to the smallest
length bucket that holds the longest (``_CHUNK_BUCKETS_SECONDS``, the JAX
package's buckets), with the padded frames masked out of attention; frame
timestamps are interpolated evenly over each chunk's true duration; a
non-finite result on the valid frames is retried once through the backend's
float32 encode. ``chunked_encode_many`` pools many clips' chunks into
cross-clip batches, grouped by bucket, with the same batch caps.

The encoders' rows are made on the backend's device: :class:`StagedClips`
copies the clips' samples there once, at their own rates, and
:meth:`StagedClips.rows` lays out a batch's padded 16 kHz rows with one
launch of ``ops/resample.py::resample_rows`` (``resample_poly``'s filter; its
plain version on the CPU). The chunks, buckets and lengths follow from the
16 kHz length alone (``ceil(n · up / down)``). Under a profiler each encode is
the spans ``ser.resample`` (the copy to the device and the launch),
``ser.encode`` (the encoder launched, a float32 retry included) and
``ser.fetch`` (the states to the host, the finite check, frame times and
assembly); :func:`count_encode` counts the encoder's calls, rows and samples
and :meth:`StagedClips.rows` the 16 kHz samples it made on either side
(``utils/profiling.py``).

Differences from the JAX package: ``encode_batch`` returns a float32 tensor
on the backend's device; ``shard_chunk_batch`` always passes its inputs
through, since one process drives one card here and a collective issued for
one request would hang the ranks that never see that request (the port
spreads work over ranks by file, in ``parallel.batch_inference.infer_many``,
and by batch, in training); and ``_gather_valid_finite`` is one plain
function on tensors (the JAX package builds a new ``jax.jit`` on every call).
"""

from __future__ import annotations

import hashlib
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np
import torch

from ser_tpu_torch._internal.pool.device_pool import device_pooling_enabled
from ser_tpu_torch._internal.repr.backend import EncodedSequence
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.profiling import count, span
from ser_tpu_torch.ops import resample

logger = get_logger(__name__)

ENCODER_SAMPLE_RATE = 16000
MAX_CHUNK_SECONDS = 30.0
#: Chunk-length buckets (seconds): the number of distinct batch shapes is bounded by them.
_CHUNK_BUCKETS_SECONDS = (1, 2, 4, 8, 15, 30)
#: Bytes of source samples that one ``chunked_encode_many`` call holds on the device at once: its
#: clips are staged in groups under it, and each group's chunks are batched by bucket.
STAGE_BYTES = 1 << 30

type EncodeBatch = Callable[[torch.Tensor, np.ndarray], torch.Tensor | np.ndarray]


def random_init_seed(backend_id: str, model_id: str) -> int:
    """Deterministic per-(backend, model) seed for random-init test mode.

    A shared seed made the medium and accurate-research eval rows
    bit-identical whenever both fell back to the same tiny config (identical
    params → identical embeddings → duplicate evidence). Salting with the
    identity keeps runs reproducible while giving every backend/model pair
    independent weights.
    """
    digest = hashlib.sha256(f"{backend_id}:{model_id}".encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big")


def resolve_local_model_dir(cache_root: Path, model_id: str) -> Path | None:
    """Finds a local weights dir for one model id (no network).

    Accepts HF-format dirs (``config.json``) and FunASR/ModelScope dirs
    (``model.pt``, the layout of the emotion2vec family).
    """
    cache_root = Path(cache_root)
    candidates = [
        cache_root / model_id,
        cache_root / model_id.replace("/", "--"),
        cache_root / "hub" / f"models--{model_id.replace('/', '--')}",
    ]

    def has_weights(path: Path) -> bool:
        return (path / "config.json").exists() or (path / "model.pt").exists()

    def snapshot_order(snapshots: Path) -> list[Path]:
        # Prefer the hash refs/main points at (the HF cache's notion of the
        # current revision); otherwise newest mtime. Lexicographic hash
        # order is unrelated to recency and can pick a superseded snapshot.
        ref = snapshots.parent / "refs" / "main"
        if ref.is_file():
            pointed = snapshots / ref.read_text(encoding="utf-8").strip()
            if pointed.is_dir():
                return [pointed]
        return sorted(
            snapshots.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True
        )

    for candidate in candidates:
        if has_weights(candidate):
            return candidate
        snapshots = candidate / "snapshots"
        if snapshots.is_dir():
            for snap in snapshot_order(snapshots):
                if has_weights(snap):
                    return snap
    return None


def plan_chunks(n_samples: int, sample_rate: int = ENCODER_SAMPLE_RATE) -> list[tuple[int, int]]:
    """Splits a clip into <=30 s chunks; returns [(start, length), ...]."""
    max_len = int(MAX_CHUNK_SECONDS * sample_rate)
    starts = list(range(0, n_samples, max_len))
    return [(s, min(max_len, n_samples - s)) for s in starts if n_samples - s > 0]


def bucket_samples(length: int, sample_rate: int = ENCODER_SAMPLE_RATE) -> int:
    """Smallest bucket (in samples) holding ``length``."""
    for seconds in _CHUNK_BUCKETS_SECONDS:
        if length <= seconds * sample_rate:
            return int(seconds * sample_rate)
    return int(_CHUNK_BUCKETS_SECONDS[-1] * sample_rate)


def shard_chunk_batch(batch: torch.Tensor, lengths: np.ndarray) -> tuple[torch.Tensor, np.ndarray, int]:
    """``(batch, lengths, true_rows)``: the batch as it is, under a process group too (see above)."""
    return batch, lengths, batch.shape[0]


def count_encode(batch: torch.Tensor, audio_samples: int) -> None:
    """Counts one encoder call over ``batch``'s rows (padding rows included), which hold
    ``audio_samples`` samples of audio, while a profiler records."""
    count(encode_calls=1, encode_rows=batch.shape[0], encode_row_samples=batch.numel(),
          encode_audio_samples=audio_samples)


def encoder_length(n_samples: int, sample_rate: int) -> int:
    """Samples of ``n_samples`` at ``sample_rate`` once resampled to 16 kHz (``resample_poly``'s length)."""
    return resample.resampled_length(n_samples, *resample.ratio(sample_rate, ENCODER_SAMPLE_RATE))


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``; to the card from pinned memory, without holding the host."""
    tensor = torch.from_numpy(array)
    return tensor.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else tensor.to(device)


class StagedClips:
    """Clips' samples at their own rates on one device: one flat float32 buffer, copied once."""

    def __init__(self, clips: Sequence[tuple[np.ndarray, int]], device: torch.device | str) -> None:
        self.device = torch.device(device)
        self.lengths = [int(audio.size) for audio, _ in clips]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
        self.ratios = [resample.ratio(rate, ENCODER_SAMPLE_RATE) for _, rate in clips]
        on_card = self.device.type == "cuda"
        host = torch.empty(sum(self.lengths), dtype=torch.float32, pin_memory=on_card)
        flat = host.numpy()
        for offset, length, (audio, _) in zip(self.offsets, self.lengths, clips):
            flat[offset : offset + length] = audio
        self.source = host.to(self.device, non_blocking=True) if on_card else host

    def rows(self, placements: Sequence[tuple[int, int, int]], row_samples: int, n_rows: int = 0) -> torch.Tensor:
        """(max(len(placements), n_rows), row_samples) float32 rows on the device: row b holds the 16 kHz
        samples ``[start, start + valid)`` of clip ``placements[b] = (clip, start, valid)``, then zeros;
        rows past the placements are zeros (padding rows). One launch per sample rate among them."""
        n_rows = max(len(placements), n_rows)
        members: dict[tuple[int, int], list[int]] = {}
        for row, (clip, _, _) in enumerate(placements):
            members.setdefault(self.ratios[clip], []).append(row)
        batch = None
        for (up, down), rows in (members or {(1, 1): []}).items():
            placed = np.zeros((n_rows, len(resample.ROW_FIELDS)), dtype=np.int64)
            for row in rows:
                clip, start, valid = placements[row]
                placed[row] = (self.offsets[clip], self.lengths[clip], start, valid)
            descriptors = resample.row_descriptors(placed, row_samples, up, down)
            part = resample.resample_rows(self.source, _to_device(descriptors, self.device), up, down, row_samples)
            # Each part is zero on the other rates' rows, so a sum keeps every value exactly.
            batch = part if batch is None else batch.add_(part)
        made = sum(valid for _, _, valid in placements)
        count(**{"resample_card_samples" if self.device.type == "cuda" else "resample_host_samples": made})
        return batch


def _stage_groups(clips: Sequence[tuple[np.ndarray, int]]) -> list[list[int]]:
    """The clips' indices in consecutive groups of at most :data:`STAGE_BYTES` of samples (a larger
    clip alone)."""
    groups: list[list[int]] = [[]]
    held = 0
    for index, (audio, _) in enumerate(clips):
        nbytes = 4 * int(audio.size)
        if groups[-1] and held + nbytes > STAGE_BYTES:
            groups.append([])
            held = 0
        groups[-1].append(index)
        held += nbytes
    return groups


def _to_host(embeddings: torch.Tensor | np.ndarray) -> np.ndarray:
    if isinstance(embeddings, torch.Tensor):
        return embeddings.detach().to("cpu").numpy()
    return np.asarray(embeddings)


def _valid_frames_finite(embeddings: np.ndarray, lengths, frames_for_length) -> bool:
    """Finiteness over VALID frames only: padded frame positions are
    contractually arbitrary (a masked softmax row may be NaN) and must not
    trigger the float32 retry or fail the batch."""
    return all(
        bool(np.all(np.isfinite(embeddings[row, : max(1, frames_for_length(int(n)))])))
        for row, n in enumerate(lengths)
    )


def _gather_valid_finite(raw: torch.Tensor, valid_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid-frame gather, float32 cast and finite reduction on the device.

    ``raw`` (B, F, D), ``valid_idx`` the flat (row · F + frame) indices of the
    valid frames. Returns ``(gathered (N, D) float32, finite)``, ``finite`` a
    0-d bool tensor: reading it is the lane's one host sync.
    """
    gathered = raw.reshape(-1, raw.shape[-1]).index_select(0, valid_idx).to(torch.float32)
    return gathered, torch.isfinite(gathered).all()


def _retry_in_float32(
    batch: torch.Tensor,
    lengths: np.ndarray,
    *,
    encode_batch: EncodeBatch,
    float32_encode_batch: Callable[[], EncodeBatch] | None,
    frames_for_length: Callable[[int], int],
    backend_id: str,
    checked_lengths: np.ndarray | None = None,
) -> np.ndarray:
    """The reference's retry after a non-finite result: once more through a float32 encode."""
    logger.warning("Non-finite embeddings from %s; retrying in float32.", backend_id)
    checked = lengths if checked_lengths is None else checked_lengths
    with span("ser.encode"):
        retry_encode = float32_encode_batch() if float32_encode_batch is not None else encode_batch
        count_encode(batch, int(checked.sum()))
        raw = retry_encode(batch, lengths)
    embeddings = _to_host(raw)
    if not _valid_frames_finite(embeddings, checked, frames_for_length):
        raise ValueError(f"Backend {backend_id} produced non-finite embeddings.")
    return embeddings


def _frame_times(start: int, length: int, n_valid: int) -> tuple[np.ndarray, np.ndarray]:
    """Start and end seconds of a chunk's frames, evenly over its true duration."""
    frame_duration = (length / ENCODER_SAMPLE_RATE) / n_valid
    frame_starts = start / ENCODER_SAMPLE_RATE + frame_duration * np.arange(n_valid)
    return frame_starts, frame_starts + frame_duration


def chunked_encode(
    audio: np.ndarray,
    sample_rate: int,
    *,
    encode_batch: EncodeBatch,
    frames_for_length: Callable[[int], int],
    backend_id: str,
    device: torch.device | str,
    float32_encode_batch: Callable[[], EncodeBatch] | None = None,
) -> EncodedSequence:
    """Runs one clip through the batched chunk encoder with exact timestamps.

    ``encode_batch(chunks (B, L) on ``device``, lengths (B,)) -> (B, F_max, D)``
    embeddings (padded frames arbitrary); ``frames_for_length(samples) -> n_valid``.
    ``float32_encode_batch``, when given, supplies a float32 encode for the
    non-finite retry (re-running the same bf16 computation would change
    nothing). With ``SER_DEVICE_POOLING=1`` the valid frames stay on the
    device as a float32 tensor, for ``device_mean_std_pool``.
    """
    if audio.ndim != 1 or audio.size == 0:
        raise ValueError("audio must be non-empty mono.")
    n_samples = encoder_length(audio.size, sample_rate)
    # Tail chunks shorter than the conv receptive field yield zero frames;
    # emitting a fully-masked garbage row instead would poison clip-end
    # features. Their audio tail is < one frame (~25 ms) — drop them.
    chunks = [c for c in plan_chunks(n_samples) if frames_for_length(c[1]) > 0]
    if not chunks:
        raise ValueError(
            f"Clip ({n_samples} samples) is shorter than the {backend_id} encoder receptive field."
        )
    n_valids = [max(1, frames_for_length(length)) for _, length in chunks]
    times = [_frame_times(start, length, n_valid) for (start, length), n_valid in zip(chunks, n_valids)]
    retry = {
        "encode_batch": encode_batch,
        "float32_encode_batch": float32_encode_batch,
        "frames_for_length": frames_for_length,
        "backend_id": backend_id,
    }

    bucket = max(bucket_samples(length) for _, length in chunks)
    with span("ser.resample"):
        staged = StagedClips([(audio, sample_rate)], device)
        batch = staged.rows([(0, start, length) for start, length in chunks], bucket)
    with span("ser.encode"):
        lengths = np.array([length for _, length in chunks], dtype=np.int32)
        sharded_batch, sharded_lengths, true_rows = shard_chunk_batch(batch, lengths)
        count_encode(batch, int(lengths.sum()))
        raw = encode_batch(sharded_batch, sharded_lengths)[:true_rows]

    with span("ser.fetch"):
        embeddings = None
        embeddings_batch = None
        if device_pooling_enabled() and isinstance(raw, torch.Tensor):
            # The frames stay on the device for the device pool; one gather and
            # one finite reduction, and the flag is the only value fetched.
            f_max = int(raw.shape[1])
            valid_idx = np.concatenate([row * f_max + np.arange(n) for row, n in enumerate(n_valids)])
            gathered, finite = _gather_valid_finite(raw, torch.from_numpy(valid_idx).to(raw.device))
            if bool(finite):
                embeddings = gathered
            else:
                embeddings_batch = _retry_in_float32(batch, lengths, **retry)
        else:
            embeddings_batch = _to_host(raw)
            if not _valid_frames_finite(embeddings_batch, lengths, frames_for_length):
                embeddings_batch = _retry_in_float32(batch, lengths, **retry)
        if embeddings is None:
            embeddings = np.concatenate(
                [embeddings_batch[row, :n_valid] for row, n_valid in enumerate(n_valids)]
            ).astype(np.float32)

        return EncodedSequence(
            embeddings=embeddings,
            frame_start_seconds=np.concatenate([starts for starts, _ in times]).astype(np.float64),
            frame_end_seconds=np.concatenate([ends for _, ends in times]).astype(np.float64),
            backend_id=backend_id,
        )


def chunked_encode_many(
    clips: list[tuple[np.ndarray, int]],
    *,
    encode_batch: EncodeBatch,
    frames_for_length: Callable[[int], int],
    backend_id: str,
    device: torch.device | str,
    max_batch_chunks: int = 32,
    attention_score_budget: float = 5e7,
    float32_encode_batch: Callable[[], EncodeBatch] | None = None,
) -> list[EncodedSequence]:
    """Encodes MANY clips with chunks pooled into large cross-clip batches.

    All clips' chunks are flattened, grouped by length bucket (padding every
    1 s chunk to a 30 s outlier's bucket would blow attention cost ~900x and
    shrink the batch cap by the same factor), and fed through the encoder in
    fixed-shape batches: rows padded up to each bucket's cap, so the number of
    batch shapes is bounded by the bucket count, not by the mix of clip
    lengths. Per-batch non-finite results retry through
    ``float32_encode_batch``, as :func:`chunked_encode` does. The clips'
    samples go to ``device`` once, in groups of at most :data:`STAGE_BYTES`
    (one group unless a call holds more), each group batched on its own.
    """
    for audio, _ in clips:
        if audio.ndim != 1 or audio.size == 0:
            raise ValueError("Every clip must be non-empty mono audio.")
    n_samples = [encoder_length(audio.size, rate) for audio, rate in clips]
    work: list[tuple[int, int, int]] = []  # (clip_index, start_sample, length)
    for clip_index, samples in enumerate(n_samples):
        clip_work = [
            (clip_index, start, length) for start, length in plan_chunks(samples) if frames_for_length(length) > 0
        ]
        if not clip_work:
            raise ValueError(
                f"Clip {clip_index} ({samples} samples) is shorter than "
                f"the {backend_id} encoder receptive field."
            )
        work.extend(clip_work)

    chunk_embeddings: dict[int, np.ndarray] = {}
    for group in _stage_groups(clips):
        with span("ser.resample"):
            staged = StagedClips([clips[clip_index] for clip_index in group], device)
        position = {clip_index: n for n, clip_index in enumerate(group)}
        by_bucket: dict[int, list[int]] = {}
        for item_index, (clip_index, _, length) in enumerate(work):
            if clip_index in position:
                by_bucket.setdefault(bucket_samples(length), []).append(item_index)

        for bucket in sorted(by_bucket):
            item_indices = by_bucket[bucket]
            # Bound B so that B * F^2 attention scores stay within budget.
            frames_per_chunk = max(1, frames_for_length(bucket))
            batch_cap = max(1, min(max_batch_chunks, int(attention_score_budget // (frames_per_chunk**2))))
            for batch_start in range(0, len(item_indices), batch_cap):
                batch_items = item_indices[batch_start : batch_start + batch_cap]
                placements = [(position[work[i][0]], work[i][1], work[i][2]) for i in batch_items]
                with span("ser.resample"):
                    # Fixed row count per (bucket, cap): silent rows pad a remainder batch.
                    batch = staged.rows(placements, bucket, batch_cap)
                with span("ser.encode"):
                    lengths = np.zeros(batch_cap, dtype=np.int32)
                    lengths[: len(batch_items)] = [length for _, _, length in placements]
                    real_lengths = lengths[: len(batch_items)]
                    count_encode(batch, int(real_lengths.sum()))
                    # Padding rows reuse the last real row's length so
                    # frames_for_length stays positive for every row.
                    lengths[len(batch_items) :] = lengths[max(0, len(batch_items) - 1)]
                    sharded_batch, sharded_lengths, true_rows = shard_chunk_batch(batch, lengths)
                    raw = encode_batch(sharded_batch, sharded_lengths)[:true_rows]
                with span("ser.fetch"):
                    out = _to_host(raw)
                    if not _valid_frames_finite(out, real_lengths, frames_for_length):
                        out = _retry_in_float32(
                            batch,
                            lengths,
                            encode_batch=encode_batch,
                            float32_encode_batch=float32_encode_batch,
                            frames_for_length=frames_for_length,
                            backend_id=backend_id,
                            checked_lengths=real_lengths,
                        )
                    for row, item_index in enumerate(batch_items):
                        chunk_embeddings[item_index] = out[row]

    sequences: list[EncodedSequence] = []
    work_index = 0
    with span("ser.fetch"):
        for samples in n_samples:
            embeddings, starts_s, ends_s = [], [], []
            for start, length in plan_chunks(samples):
                n_valid = frames_for_length(length)
                if n_valid <= 0:
                    continue
                embeddings.append(chunk_embeddings[work_index][:n_valid])
                work_index += 1
                frame_starts, frame_ends = _frame_times(start, length, n_valid)
                starts_s.append(frame_starts)
                ends_s.append(frame_ends)
            stacked = np.concatenate(embeddings).astype(np.float32)
            if not np.all(np.isfinite(stacked)):
                raise ValueError(f"Backend {backend_id} produced non-finite embeddings.")
            sequences.append(
                EncodedSequence(
                    embeddings=stacked,
                    frame_start_seconds=np.concatenate(starts_s).astype(np.float64),
                    frame_end_seconds=np.concatenate(ends_s).astype(np.float64),
                    backend_id=backend_id,
                )
            )
    return sequences


__all__ = [
    "ENCODER_SAMPLE_RATE",
    "MAX_CHUNK_SECONDS",
    "STAGE_BYTES",
    "StagedClips",
    "bucket_samples",
    "chunked_encode",
    "chunked_encode_many",
    "count_encode",
    "encoder_length",
    "plan_chunks",
    "random_init_seed",
    "resolve_local_model_dir",
    "shard_chunk_batch",
]
