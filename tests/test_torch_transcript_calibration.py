"""Transcription profiling and calibration of the port against ``ser_tpu``.

Every public function of ``_internal/transcript/profiling.py`` and
``calibration.py`` on the same inputs as the JAX package's, returning the
same values; the card is the port's accelerator, so its probes report
``"cuda"`` where the JAX package's report ``"tpu"``, and the reports keep
the JAX keys and strings. A report written by either package reads in the
other's loader and admission gate.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.transcript import calibration as jax_calibration
from ser_tpu._internal.transcript import hbm_admission as jax_admission
from ser_tpu._internal.transcript import profiling as jax_profiling
from ser_tpu.domain import TranscriptWord as JaxTranscriptWord
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.transcript import calibration, hbm_admission, profiling
from ser_tpu_torch.domain import TranscriptWord


@pytest.mark.parametrize(
    ("reference", "hypothesis"),
    [
        ("kids are talking by the door", "kids are talking by the door"),
        ("kids are talking by the door", "Kids, are talking by the door's!"),
        ("dogs are sitting by the door", "dogs sitting by a door door"),
        ("", ""),
        ("", "noise"),
        ("one two three", ""),
    ],
)
def test_word_error_rate_matches(reference, hypothesis) -> None:
    assert profiling.word_error_rate(reference, hypothesis) == jax_profiling.word_error_rate(reference, hypothesis)


@pytest.mark.parametrize("fraction", [0.1, 0.5, 0.9, 0.95, 1.0])
@pytest.mark.parametrize("values", [[], [3.0], [5.0, 1.0, 4.0, 2.0, 3.0], list(np.linspace(0.1, 2.0, 17))])
def test_nearest_rank_percentile_matches(values, fraction) -> None:
    assert profiling.nearest_rank_percentile(list(values), fraction) == jax_profiling.nearest_rank_percentile(
        list(values), fraction
    )


def _scripted(outputs: dict[str, str], word_type):
    def transcribe(path: str):
        return [word_type(word=w, start_seconds=0.0, end_seconds=0.1) for w in outputs[path].split()]

    return transcribe


SAMPLES = [("a.wav", "kids are talking by the door"), ("b.wav", "dogs are sitting by the door"), ("c.wav", "kids are talking by the door")]
OUTPUTS = {"a.wav": "kids are talking by the door", "b.wav": "dogs sitting by door", "c.wav": "kids talking by the"}


def test_profile_transcription_candidate_matches() -> None:
    ours = profiling.profile_transcription_candidate(_scripted(OUTPUTS, TranscriptWord), SAMPLES, backend_id="jax_whisper", model_name="large")
    ref = jax_profiling.profile_transcription_candidate(_scripted(OUTPUTS, JaxTranscriptWord), SAMPLES, backend_id="jax_whisper", model_name="large")
    assert (ours.backend_id, ours.model_name, ours.mean_wer, ours.samples) == (ref.backend_id, ref.model_name, ref.mean_wer, ref.samples)
    assert 0.0 <= ours.p50_latency_seconds <= ours.p95_latency_seconds
    with pytest.raises(ValueError, match="at least one"):
        profiling.profile_transcription_candidate(_scripted(OUTPUTS, TranscriptWord), [], backend_id="b", model_name="m")


def _candidate_reports(module):
    return [
        module.TranscriptionCandidateReport("jax_whisper", "large", 0.10, 2.0, 2.5, 5),
        module.TranscriptionCandidateReport("jax_whisper", "turbo", 0.20, 1.0, 1.2, 5),
        module.TranscriptionCandidateReport("jax_whisper", "tiny", 0.50, 0.2, 0.3, 5),
        module.TranscriptionCandidateReport("jax_whisper", "small", 0.25, 0.8, 0.9, 2),
    ]


@pytest.mark.parametrize("subset", [slice(0, 4), slice(0, 1), slice(2, 3), slice(3, 4), slice(1, 3)])
@pytest.mark.parametrize("gate", [0.30, 0.05])
def test_recommend_default_matches(subset, gate) -> None:
    ours = profiling.recommend_default(_candidate_reports(profiling)[subset], max_acceptable_wer=gate)
    ref = jax_profiling.recommend_default(_candidate_reports(jax_profiling)[subset], max_acceptable_wer=gate)
    mine, theirs = ours.to_dict(), ref.to_dict()
    assert abs(mine.pop("generated_at_unix") - theirs.pop("generated_at_unix")) < 60.0
    assert mine == theirs
    with pytest.raises(ValueError):
        profiling.recommend_default([])


def _write_v1(module, path: Path, *, model: str = "large", confidence: str = "high", age_hours: float = 1.0) -> None:
    recommendation = module.CalibrationRecommendation(
        backend_id="jax_whisper", model_name=model, confidence=confidence, mean_wer=0.1,
        p50_latency_seconds=1.0, generated_at_unix=time.time() - age_hours * 3600.0,
    )
    module.save_calibration_report(recommendation, _candidate_reports(module)[:2], path)


@pytest.mark.parametrize(("writer", "reader"), [(jax_profiling, profiling), (profiling, jax_profiling), (profiling, profiling)])
def test_reports_read_across_packages(tmp_path, writer, reader) -> None:
    path = tmp_path / "transcription_calibration.json"
    _write_v1(writer, path)
    loaded = reader.load_calibration_report(path)
    assert loaded is not None and loaded.model_name == "large" and loaded.confidence == "high"
    raw = json.loads(path.read_text())
    assert set(raw) == {"recommendation", "candidates"} and raw["candidates"][1]["model_name"] == "turbo"


@pytest.mark.parametrize(
    "content", ["not json", json.dumps({"recommendation": {"confidence": "certain"}}), json.dumps({"other": 1}),
                json.dumps({"recommendation": {"backend_id": "b", "model_name": "m", "confidence": "sure",
                                               "mean_wer": 0.1, "p50_latency_seconds": 1.0, "generated_at_unix": 0.0}})],
)
def test_unreadable_reports_read_as_none(tmp_path, content) -> None:
    path = tmp_path / "report.json"
    path.write_text(content)
    assert profiling.load_calibration_report(path) is None and jax_profiling.load_calibration_report(path) is None
    assert profiling.load_calibration_report(tmp_path / "absent.json") is None


def test_default_report_path_matches(tmp_path) -> None:
    assert profiling.default_calibration_report_path(tmp_path) == jax_profiling.default_calibration_report_path(tmp_path)


@pytest.mark.parametrize(
    ("writer", "model", "confidence", "age_hours"),
    [
        ("jax", "large", "high", 1.0),
        ("torch", "large", "high", 1.0),
        ("torch", "large", "medium", 1.0),
        ("jax", "turbo", "high", 1.0),
        ("torch", "large", "high", 500.0),
    ],
)
def test_admission_reads_either_packages_report(tmp_path, writer, model, confidence, age_hours) -> None:
    path = tmp_path / "transcription_calibration.json"
    _write_v1(jax_profiling if writer == "jax" else profiling, path, model=model, confidence=confidence, age_hours=age_hours)
    ours = hbm_admission.calibration_admission_override("large", build_settings({}).transcription, default_report_path=path)
    ref = jax_admission.calibration_admission_override(
        "large", build_settings_from_inputs(capture_settings_inputs({})).transcription, default_report_path=path
    )
    assert ours == ref
    assert (ours is not None) == (model == "large" and confidence == "high" and age_hours < 168.0)


# --------------------------------------------------------------------------- #
# calibration.py
# --------------------------------------------------------------------------- #

RAVDESS_NAMES = [
    f"03-01-{emotion:02d}-01-{statement:02d}-{rep:02d}-{actor:02d}.wav"
    for actor in (1, 2, 3, 4)
    for emotion in (1, 3, 5)
    for statement in (1, 2)
    for rep in (1, 2)
] + ["notes.wav", "03-01-01-01-03-01-05.wav", "a-b.wav"]


@pytest.mark.parametrize("name", RAVDESS_NAMES[::7] + RAVDESS_NAMES[-3:])
def test_ravdess_parsing_matches(name) -> None:
    path = Path("/data") / name
    assert calibration.ravdess_reference_text(path) == jax_calibration.ravdess_reference_text(path)
    ours, ref = calibration.parse_ravdess_metadata(path), jax_calibration.parse_ravdess_metadata(path)
    assert (ours is None and ref is None) or dataclasses.astuple(ours) == dataclasses.astuple(ref)


@pytest.mark.parametrize("limit", [1, 3, 7, 20, 200])
@pytest.mark.parametrize("seed", [0, 42])
def test_stratified_subset_and_samples_match(limit, seed) -> None:
    paths = [Path("/data") / name for name in RAVDESS_NAMES]
    ours = calibration.stratified_reference_subset(paths, limit=limit, random_seed=seed)
    assert ours == jax_calibration.stratified_reference_subset(paths, limit=limit, random_seed=seed)
    assert calibration.summarize_subset_coverage(ours) == jax_calibration.summarize_subset_coverage(ours)
    for strategy in ("stratified", "head"):
        assert calibration.collect_reference_samples(paths, limit=limit, sampling_strategy=strategy, random_seed=seed) == (
            jax_calibration.collect_reference_samples(paths, limit=limit, sampling_strategy=strategy, random_seed=seed)
        )


def test_collect_reference_samples_refusals_match() -> None:
    for kwargs, match in (({"limit": 0}, "positive"), ({"limit": 2, "sampling_strategy": "random"}, "sampling_strategy")):
        with pytest.raises(ValueError, match=match):
            calibration.collect_reference_samples(["a.wav"], **kwargs)
        with pytest.raises(ValueError, match=match):
            jax_calibration.collect_reference_samples(["a.wav"], **kwargs)
    assert calibration.collect_reference_samples(RAVDESS_NAMES) == jax_calibration.collect_reference_samples(RAVDESS_NAMES)


@pytest.mark.parametrize("raw", ["fast,accurate", " Medium , medium,fast ", "accurate-research", "", "fast,slow", ",,"])
def test_profile_csv_matches(raw) -> None:
    try:
        ref = jax_calibration.normalize_calibration_profile_csv(raw)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)[:20]):
            calibration.normalize_calibration_profile_csv(raw)
        with pytest.raises(ValueError):
            calibration.parse_calibration_profiles(raw)
        return
    assert calibration.normalize_calibration_profile_csv(raw) == ref == calibration.parse_calibration_profiles(raw)


@pytest.mark.parametrize("latencies", [[], [0.5], [0.3, 0.1, 0.9, 0.4, 0.2, 0.7]])
def test_latency_percentiles_match(latencies) -> None:
    assert dataclasses.astuple(calibration.latency_percentiles(latencies)) == dataclasses.astuple(
        jax_calibration.latency_percentiles(latencies)
    )


def _failing_on(paths: set[str], outputs: dict[str, str], word_type):
    inner = _scripted(outputs, word_type)

    def transcribe(path: str):
        if path in paths:
            raise RuntimeError(f"corrupt {path}")
        return inner(path)

    return transcribe


@pytest.mark.parametrize("failing", [set(), {"b.wav"}, {"a.wav"}, {"a.wav", "b.wav", "c.wav"}])
def test_profile_candidate_matrix_matches(failing) -> None:
    samples = [(f"/data/{RAVDESS_NAMES[i]}", text) for i, (_, text) in enumerate(SAMPLES)]
    outputs = {path: OUTPUTS[name] for (path, _), (name, _) in zip(samples, SAMPLES)}
    failing_paths = {path for (path, _), (name, _) in zip(samples, SAMPLES) if name in failing}
    ours = calibration.profile_candidate_matrix(_failing_on(failing_paths, outputs, TranscriptWord), samples,
                                                backend_id="jax_whisper", model_name="large", iterations=2)
    ref = jax_calibration.profile_candidate_matrix(_failing_on(failing_paths, outputs, JaxTranscriptWord), samples,
                                                   backend_id="jax_whisper", model_name="large", iterations=2)
    mine, theirs = dataclasses.asdict(ours), dataclasses.asdict(ref)
    mine.pop("latency"), theirs.pop("latency")
    assert mine == theirs
    assert dataclasses.asdict(ours.to_candidate_report())["mean_wer"] == ref.mean_wer


def _entry(module, name, wer, mean_latency, samples=5, error=None):
    latency = module.LatencyPercentiles(mean_latency, mean_latency, mean_latency, mean_latency, mean_latency,
                                        mean_latency, mean_latency)
    return module.CandidateMatrixEntry("jax_whisper", name, wer, latency, samples, 0, error, {"actors": 2})


def _entries(module):
    return [
        _entry(module, "large", 0.10, 2.0),
        _entry(module, "turbo", 0.12, 1.0),
        _entry(module, "tiny", 0.40, 0.2),
        _entry(module, "small", 0.11, 0.5, samples=2),
        _entry(module, "medium", 0.11, 0.6, error="boom"),
        _entry(module, "base", 0.13, 1.5),
    ]


@pytest.mark.parametrize("subset", [slice(0, 6), slice(0, 1), slice(0, 3), slice(3, 6)])
@pytest.mark.parametrize(("floor", "drop", "speedup"), [(0.70, 0.05, 1.25), (0.95, 0.01, 3.0)])
def test_gate_and_default_recommendation_match(subset, floor, drop, speedup) -> None:
    ours_entries, ref_entries = _entries(calibration)[subset], _entries(jax_calibration)[subset]
    ours_gate = calibration.derive_accuracy_gate(ours_entries[0], absolute_accuracy_floor=floor, maximum_accuracy_drop=drop)
    ref_gate = jax_calibration.derive_accuracy_gate(ref_entries[0], absolute_accuracy_floor=floor, maximum_accuracy_drop=drop)
    assert dataclasses.asdict(ours_gate) == dataclasses.asdict(ref_gate)
    for minimum in (3, 6):
        ours = calibration.recommend_default_candidate(ours_entries, ours_gate, minimum_speedup_ratio=speedup,
                                                       minimum_required_samples=minimum)
        ref = jax_calibration.recommend_default_candidate(ref_entries, ref_gate, minimum_speedup_ratio=speedup,
                                                          minimum_required_samples=minimum)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


class _Model:
    def __init__(self, device: str) -> None:
        self.device = device


def _probe(module, accelerator: str, script: list[str]):
    """Scripted probes: each iteration loads on the accelerator or the CPU, then succeeds, moves, fails or runs out of memory."""
    outcomes = iter(script)
    state = {}

    def load_model():
        outcome = next(outcomes)
        state["outcome"] = outcome
        if outcome == "load-oom":
            raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB" if accelerator == "cuda"
                               else "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2 bytes")
        return _Model("cpu" if outcome == "cpu" else accelerator)

    def transcribe(model, path):
        outcome = state["outcome"]
        if outcome == "fail":
            raise ValueError("decode failed")
        if outcome == "oom":
            raise RuntimeError("out of memory")
        if outcome == "move":
            model.device = "cpu"

    return module.run_runtime_calibration_probes(
        calibration_file="clip.wav", iterations=len(script), load_model=load_model, transcribe=transcribe,
        device_of=lambda model: model.device,
    )


SCRIPTS = [
    [],
    ["ok"],
    ["ok", "ok", "ok"],
    ["cpu", "cpu"],
    ["ok", "oom", "ok"],
    ["load-oom", "load-oom", "ok"],
    ["ok", "move", "ok", "move"],
    ["ok", "fail", "fail", "cpu"],
    ["move", "fail"],
]


@pytest.mark.parametrize("script", SCRIPTS)
def test_runtime_probes_and_recommendation_match(script) -> None:
    """The card counts where the TPU does; the stats and the recommendation strings are the JAX package's."""
    ours = _probe(calibration, "cuda", script)
    ref = _probe(jax_calibration, "tpu", script)
    mine, theirs = dataclasses.asdict(ours), dataclasses.asdict(ref)
    mine.pop("mean_latency_seconds"), theirs.pop("mean_latency_seconds")
    mine.pop("error_messages"), theirs.pop("error_messages")
    assert mine == theirs
    assert calibration.derive_runtime_recommendation(ours) == jax_calibration.derive_runtime_recommendation(ref)
    assert calibration.is_hard_tpu_oom(RuntimeError("CUDA out of memory")) and not calibration.is_hard_tpu_oom(
        RuntimeError("bad shape")
    )


@pytest.mark.parametrize("with_runtime", [False, True])
def test_build_and_save_report_match_and_read_across(tmp_path, with_runtime) -> None:
    stats = {"ours": _probe(calibration, "cuda", ["ok", "ok", "ok"]), "ref": _probe(jax_calibration, "tpu", ["ok", "ok", "ok"])}
    ours = calibration.build_calibration_report(_entries(calibration), runtime_stats=stats["ours"] if with_runtime else None,
                                                now=lambda: 1000.0)
    ref = jax_calibration.build_calibration_report(_entries(jax_calibration), runtime_stats=stats["ref"] if with_runtime else None,
                                                   now=lambda: 1000.0)
    if with_runtime:
        for payload in (ours, ref):
            payload["runtime"]["stats"].pop("mean_latency_seconds")
            assert payload["runtime"]["recommendation"] == "prefer_tpu"
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    assert ours["version"] == calibration.CALIBRATION_REPORT_VERSION == 2
    for writer, reader in ((calibration, jax_profiling), (jax_calibration, profiling)):
        path = tmp_path / f"{writer.__name__}.json"
        payload = ours if writer is calibration else ref
        assert writer.save_calibration_report_v2(payload, path) == str(path)
        assert not path.with_suffix(".json.tmp").exists()
        loaded = reader.load_calibration_report(path)
        assert loaded is not None and loaded.to_dict() == payload["recommendation"]
        assert (loaded.model_name, loaded.confidence) == ("small", "medium")  # fastest under the WER gate; 2 samples
