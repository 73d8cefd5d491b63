"""Batch inference: many clips through one encoder profile.

Counterpart of ``ser_tpu/parallel/batch_inference.py``, the throughput
surface for serving: clips are decoded on host threads (a file that fails to
decode is contained in its row), encoded through ``encode_clips`` (for the
medium and accurate-research profiles ``chunked_encode_many``, which batches
chunks across clips; the accurate profile encodes each clip's 30 s windows
in one batch), and the deterministic window → pool → predict → postprocess
pass runs per clip. On the card the accurate encode runs kernels K1 and K2,
medium's masked K2 (K2-f32 on its float32 retry). Under a profiler each call
is the span ``ser.infer_many``, around ``ser.decode`` and the encode's and the
per-clip pass's stage spans (``utils/profiling.py``).

The JAX package, one controller over its devices, shards the cross-clip
batches over the mesh's data axis. Here each process drives one device, so
the work is split at the file level: under an initialized process group,
each rank of the mesh's data axis (``settings.mesh``) takes every n-th file,
and the rows are gathered back in input order (``all_gather_object``) on
every rank. The ranks of one data index along the model axis (the inference
encoder is not cut) compute the same rows. A group of one rank takes every
file and gathers its own rows: the JAX package's function, through the
collective path. Without a group it is the JAX package's function.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime.postprocessing import build_segment_postprocessing_config
from ser_tpu_torch._internal.runtime.profile_execution import run_windowed_inference_once
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.profiling import span
from ser_tpu_torch.parallel.mesh import mesh_shape_for
from ser_tpu_torch.profiles import ProfileName, require_ported
from ser_tpu_torch.runtime.schema import InferenceResult

logger = get_logger(__name__)


@dataclass(frozen=True)
class BatchInferenceResult:
    """Per-file outcome of one batch run."""

    file_path: str
    result: InferenceResult | None
    error: str | None = None


def infer_many(
    file_paths: list[str],
    *,
    profile: ProfileName = "accurate",
    settings: AppConfig | None = None,
    decode_workers: int = 8,
) -> list[BatchInferenceResult]:
    """Runs one profile over many files with batched encoding.

    Per-file decode failures are contained (reported in the result row);
    encode/predict failures raise, since they indicate a systemic problem
    (on every rank, when the files are split over a process group).
    """
    with span("ser.infer_many"):
        settings = settings if settings is not None else reload_settings()
        spec = require_ported(profile)
        if profile == "fast":
            raise ValueError("Batch inference targets encoder profiles; use api.infer for fast.")

        # The serving path's gates (backend_hooks.build_backend_hooks): batch
        # inference must not become a side door around a profile's enable flag
        # or a restricted backend's license consent.
        from ser_tpu_torch._internal.runtime import restricted_backends
        from ser_tpu_torch._internal.runtime.backend_hooks import _profile_enabled

        if not _profile_enabled(profile, settings):
            raise ValueError(f"Profile {profile!r} is disabled (enable it via its runtime flag).")
        if spec.backend_id in restricted_backends.RESTRICTED_BACKEND_POLICIES:
            restricted_backends.ensure_backend_access(spec.backend_id, settings=settings)

        split = _data_split(settings)
        if split is None:
            return [row for _, row in _indexed_rows(list(enumerate(file_paths)), profile, settings, decode_workers)]
        data_index, parts = split
        try:
            mine = list(enumerate(file_paths))[data_index::parts]
            outcome = (_indexed_rows(mine, profile, settings, decode_workers), None)
        except Exception as err:  # noqa: BLE001 - raised on every rank after the gather
            outcome = ([], f"{type(err).__name__}: {err}")
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (data_index, outcome))
        failures = [f"data rank {index}: {error}" for index, (_, error) in gathered if error is not None]
        if failures:
            raise RuntimeError("Batch inference failed: " + "; ".join(failures))
        rows = {row_index: row for _, (indexed, _) in gathered for row_index, row in indexed}
        return [rows[row_index] for row_index in sorted(rows)]


def _data_split(settings: AppConfig) -> tuple[int, int] | None:
    """(this rank's data index, data axis size) under a process group, else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    data, model = mesh_shape_for(dist.get_world_size(), settings.mesh)
    return dist.get_rank() // model, data


def _indexed_rows(
    indexed_paths: list[tuple[int, str]], profile: ProfileName, settings: AppConfig, decode_workers: int
) -> list[tuple[int, BatchInferenceResult]]:
    """The JAX package's function over ``indexed_paths``: (input position, row) in input order."""
    from ser_tpu_torch._internal.repr.encode_util import encode_clips
    from ser_tpu_torch._internal.repr.encoders import build_encoder_backend, resolved_model_id
    from ser_tpu_torch._internal.runtime.backend_hooks import build_profile_spec

    boundary_spec = build_profile_spec(profile, settings)
    backend = build_encoder_backend(profile, settings)
    loaded = artifacts.load_model_artifact(
        settings.models.folder / boundary_spec.artifact_file_name,
        expected_backend_id=boundary_spec.backend_id,
        expected_profile=profile,
        expected_model_id=resolved_model_id(profile, settings) or None,
        device=resolve_device(settings.torch_runtime.device),
    )
    runtime = settings.profile_runtime(profile)
    postprocessing = build_segment_postprocessing_config(runtime)

    rows: dict[int, BatchInferenceResult] = {}
    decoded: list[tuple[int, np.ndarray, int]] = []

    def decode(indexed):
        index, path = indexed
        try:
            audio, sr = read_audio_file(path, audio_read_config=settings.audio_read)
            return (index, audio, sr)
        except Exception as err:  # noqa: BLE001 - contained per file
            rows[index] = BatchInferenceResult(path, None, error=f"{type(err).__name__}: {err}")
            return None

    # The span waits on the decode threads from the calling thread, which is the one a trace sees.
    with span("ser.decode"), ThreadPoolExecutor(max_workers=max(1, decode_workers)) as pool:
        for item in pool.map(decode, indexed_paths):
            if item is not None:
                decoded.append(item)
    paths = dict(indexed_paths)
    if decoded:
        clips = [(audio, sr) for _, audio, sr in decoded]
        sequences = encode_clips(backend, clips)
        if len(sequences) != len(decoded):
            raise RuntimeError(
                f"Backend returned {len(sequences)} encoded sequences for "
                f"{len(decoded)} clips; refusing to silently drop files."
            )
        for (index, audio, sr), encoded in zip(decoded, sequences):
            result = run_windowed_inference_once(
                audio=audio,
                sample_rate=sr,
                backend=backend,
                model=loaded.model,
                pool_window_size_seconds=runtime.pool_window_size_seconds,
                pool_window_stride_seconds=runtime.pool_window_stride_seconds,
                postprocessing_config=postprocessing,
                output_schema_version=settings.schema.output_schema_version,
                expected_feature_size=loaded.expected_feature_size,
                encode_fn=lambda *_args, _encoded=encoded: _encoded,
            )
            rows[index] = BatchInferenceResult(paths[index], result)
    return [(index, rows[index]) for index, _ in indexed_paths if index in rows]


__all__ = ["BatchInferenceResult", "infer_many"]
