"""The port's stage spans and encoder counters (``_internal/utils/profiling.py``), on the CPU.

``infer_many`` runs under ``torch.profiler`` on tiny random-init encoders (the
accurate profile's Whisper and the medium profile's XLS-R, through the port's
own ``SER_ALLOW_RANDOM_INIT`` draw) over three short WAVs at 48 and 16 kHz:

- every stage span lies inside the call's root span ``ser.infer_many``, as
  often as the call's files and encoder calls give;
- the counters hold exactly the encoder calls, rows and samples that the
  resampled lengths give, and the 16 kHz samples the row layout made, all on
  the host here;
- with no profiler on, no span is entered, nothing is counted, and the rows
  are those of the profiled run.

Besides, ``timed_phase``'s phase is a span too.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr import encoders
from ser_tpu_torch._internal.repr.encoder_backend import bucket_samples
from ser_tpu_torch._internal.runtime import phases
from ser_tpu_torch._internal.runtime.backend_hooks import build_profile_spec
from ser_tpu_torch._internal.utils import profiling
from ser_tpu_torch._internal.utils.audio_io import write_wav
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.parallel.batch_inference import infer_many

LABELS = ["angry", "happy", "neutral", "sad"]
#: (seconds, sample rate): at 16 kHz the medium profile puts them in its 1, 2 and 4 s buckets.
CLIPS = ((1.3, 48000), (0.9, 16000), (2.2, 48000))
#: Rows of each of the medium profile's batches here: ``max_batch_chunks``, which the
#: attention budget does not cut below 30 s buckets.
MEDIUM_BATCH_ROWS = 32
WHISPER_WINDOW = 480000
STAGES = ("ser.decode", "ser.resample", "ser.encode", "ser.fetch", "ser.pool", "ser.classify")


def _resampled(seconds: float, rate: int) -> int:
    """``resample_poly``'s output length at 16 kHz."""
    samples = int(seconds * rate)
    return samples if rate == 16000 else math.ceil(samples * 16000 / rate)


def _write_head(path: Path, profile: str, backend_id: str, model_id: str, width: int) -> None:
    rng = np.random.default_rng(0)
    dims = [2 * width, 16, len(LABELS)]
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [16], "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8,
        "max_iter": 500, "random_state": 42, "classes": LABELS,
        "weights": [rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a) for a, b in zip(dims, dims[1:])],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]], "n_iter": 1, "loss": 1.0,
    }
    metadata = artifacts.build_artifact_metadata(
        feature_vector_size=2 * width, training_samples=8, labels=LABELS, backend_id=backend_id, profile=profile,
        pooling_strategy="mean_std", backend_model_id=model_id,
    )
    head = TorchMLPClassifier.from_state(state, device="cpu")
    artifacts.save_model_artifact(artifacts.build_model_artifact(head, metadata), path)


@pytest.fixture(scope="module", params=["accurate", "medium"])
def staged(request, tmp_path_factory):
    """One profile's settings, files and encoder, and its ``infer_many`` run once under a CPU profiler."""
    profile = request.param
    root = tmp_path_factory.mktemp(f"spans_{profile}")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("SER_ALLOW_RANDOM_INIT", "1")
        patch.setenv("SER_RANDOM_INIT_SIZE", "tiny")
        settings = build_settings({
            f"SER_ENABLE_{profile.upper()}_PROFILE": "1",
            "SER_MODELS_FOLDER": str(root / "models"),
            "SER_CACHE_DIR": str(root / "cache"),
            "SER_TORCH_DEVICE": "cpu",
        })
        spec = build_profile_spec(profile, settings)
        backend = encoders.build_encoder_backend(profile, settings)
        _write_head(settings.models.folder / spec.artifact_file_name, profile, spec.backend_id,
                    encoders.resolved_model_id(profile, settings), backend.feature_dim)
        paths = []
        for index, (seconds, rate) in enumerate(CLIPS):
            t = np.arange(int(seconds * rate)) / rate
            noise = np.random.default_rng(index).standard_normal(t.size)
            audio = np.sin(2 * np.pi * (200 + 90 * index) * t) + 0.1 * noise
            paths.append(str(root / f"clip{index}.wav"))
            write_wav(paths[-1], (0.5 * audio / np.abs(audio).max()).astype(np.float32), rate)
        profiling.reset_counts()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as traced:
            rows = infer_many(paths, profile=profile, settings=settings)
        yield {"profile": profile, "settings": settings, "paths": paths, "rows": rows,
               "events": traced.events(), "counts": profiling.counts()}
        profiling.reset_counts()
        encoders._BACKEND_CACHE.clear()


def _ancestors(event):
    parent = event.cpu_parent
    while parent is not None:
        yield parent
        parent = parent.cpu_parent


def test_stage_spans_nest_in_the_root_span(staged):
    assert all(row.error is None for row in staged["rows"])
    spans = [event for event in staged["events"] if event.name.startswith("ser.")]
    roots = [event for event in spans if event.name == "ser.infer_many"]
    assert len(roots) == 1
    for event in spans:
        if event.name != "ser.infer_many":
            assert roots[0] in list(_ancestors(event)), event.name
    found = {stage: sum(event.name == stage for event in spans) for stage in STAGES}
    files = len(CLIPS)
    if staged["profile"] == "accurate":
        # One encode a file: each file's windows are one encoder call.
        encodes = {"ser.resample": files, "ser.encode": files, "ser.fetch": files}
    else:
        # One copy of the call's clips and one row layout a bucket, one encode a bucket, and the
        # assembly's fetch.
        encodes = {"ser.resample": 1 + files, "ser.encode": files, "ser.fetch": files + 1}
    assert found == {"ser.decode": 1, **encodes, "ser.pool": files, "ser.classify": files}


def test_counters_hold_the_encoders_rows_and_samples(staged):
    lengths = [_resampled(seconds, rate) for seconds, rate in CLIPS]
    if staged["profile"] == "accurate":
        rows = [math.ceil(n / WHISPER_WINDOW) for n in lengths]
        row_samples = [r * WHISPER_WINDOW for r in rows]
    else:
        assert len({bucket_samples(n) for n in lengths}) == len(lengths)
        rows = [MEDIUM_BATCH_ROWS] * len(lengths)
        row_samples = [MEDIUM_BATCH_ROWS * bucket_samples(n) for n in lengths]
    assert staged["counts"] == {
        "encode_calls": len(CLIPS),
        "encode_rows": sum(rows),
        "encode_row_samples": sum(row_samples),
        "encode_audio_samples": sum(lengths),
        "resample_card_samples": 0,
        "resample_host_samples": sum(lengths),
    }


def test_profiler_off_enters_no_span_and_counts_nothing(staged, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} entered with no profiler on")

    monkeypatch.setattr(profiling, "_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counts()
    assert not torch.autograd._profiler_enabled()
    rows = infer_many(staged["paths"], profile=staged["profile"], settings=staged["settings"])
    assert profiling.counts() == dict.fromkeys(profiling.COUNTER_NAMES, 0)
    assert rows == staged["rows"]


def test_timed_phase_is_a_span_under_a_profiler():
    """A phase also lies on a profiler's clock, as ``ser.phase.<name>``, and still times."""
    timings: dict[str, float] = {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as traced:
        with phases.timed_phase("emotion_inference", timings):
            torch.ones(8).sum()
    assert timings["emotion_inference"] > 0.0
    assert [event.name for event in traced.events()].count("ser.phase.emotion_inference") == 1

