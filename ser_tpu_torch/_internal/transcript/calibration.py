"""Transcription runtime calibration: the candidate matrix, the gate, the device probes, the report.

Counterpart of ``ser_tpu/_internal/transcript/calibration.py``: the RAVDESS
reference subsets (metadata from the file name, stratified canonical
subsets, coverage), each candidate's WER and latency-percentile matrix, the
accuracy gate derived from the baseline and the speedup-gated default
recommendation, the device-stability probes with their load, failover and
hard-OOM accounting, and the versioned report.

The report is an artifact format (``ROADMAP.md`` rule (b)): its keys and its
recommendation and reason strings are exactly those ``ser_tpu`` writes, so
each package reads the other's reports. The port's accelerator is the CUDA
card: ``device_of`` reports ``"cuda"`` (or ``"cpu"``) where the JAX
package's reports ``"tpu"``, and the card's runs are counted under the JAX
names (``tpu_loaded_runs``, ``tpu_completed_runs``,
``tpu_to_cpu_failover_runs``, ``hard_tpu_oom_runs``) and recommended as
``prefer_tpu`` / ``tpu_with_failover`` / ``prefer_cpu`` (``ROADMAP.md``,
Queue 3). A hard OOM is a CUDA out-of-memory error (``runtime/oom.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import statistics
import time
from collections.abc import Callable, Sequence
from dataclasses import asdict, dataclass, field
from pathlib import Path

from ser_tpu_torch._internal.runtime.oom import is_device_oom
from ser_tpu_torch._internal.transcript.profiling import (
    RAVDESS_CANONICAL_SENTENCES,
    TranscriptionCandidateReport,
    nearest_rank_percentile,
    recommend_default,
    word_error_rate,
)
from ser_tpu_torch.domain import TranscriptWord

#: What ``device_of`` reports for a model on the card.
ACCELERATOR = "cuda"

#: RAVDESS statement code → canonical sentence (filename field 5).
STATEMENT_TEXT: dict[str, str] = {
    "01": RAVDESS_CANONICAL_SENTENCES[0],
    "02": RAVDESS_CANONICAL_SENTENCES[1],
}

VALID_CALIBRATION_PROFILES = ("fast", "medium", "accurate", "accurate-research")


# --------------------------------------------------------------------------- #
# RAVDESS reference selection (stratified canonical subsets)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class RavdessMetadata:
    """Parsed fields from a RAVDESS filename (modality-...-actor)."""

    emotion_code: str
    statement_code: str
    actor_id: str


def ravdess_reference_text(file_path: Path) -> str | None:
    """Ground-truth transcript for one RAVDESS clip, or None."""
    parts = file_path.stem.split("-")
    if len(parts) < 5:
        return None
    return STATEMENT_TEXT.get(parts[4])


def parse_ravdess_metadata(file_path: Path) -> RavdessMetadata | None:
    """Actor/emotion/statement metadata from one RAVDESS filename."""
    parts = file_path.stem.split("-")
    if len(parts) < 7:
        return None
    return RavdessMetadata(emotion_code=parts[2], statement_code=parts[4], actor_id=parts[6])


def stratified_reference_subset(
    references: Sequence[Path], *, limit: int, random_seed: int = 42
) -> list[Path]:
    """Deterministic near-uniform subset across (actor, statement) strata.

    Round-robin over shuffled strata so small limits still cover both
    canonical sentences and many actors — a head-truncated subset would
    measure one speaker's WER and call it the model's.
    """
    if limit >= len(references):
        return list(references)
    strata: dict[tuple[str, str], list[Path]] = {}
    for file_path in references:
        metadata = parse_ravdess_metadata(file_path)
        if metadata is None:
            continue
        strata.setdefault((metadata.actor_id, metadata.statement_code), []).append(file_path)
    if not strata:
        return list(references[:limit])

    rng = random.Random(random_seed)
    keys = sorted(strata)
    rng.shuffle(keys)
    for key in keys:
        strata[key] = sorted(strata[key])
        rng.shuffle(strata[key])

    selected: list[Path] = []
    cursor = dict.fromkeys(keys, 0)
    while len(selected) < limit:
        progressed = False
        for key in keys:
            index = cursor[key]
            if index >= len(strata[key]):
                continue
            selected.append(strata[key][index])
            cursor[key] = index + 1
            progressed = True
            if len(selected) >= limit:
                break
        if not progressed:
            break
    return sorted(selected)


def summarize_subset_coverage(files: Sequence[Path]) -> dict[str, int]:
    """Distinct actor/emotion/statement counts in one selected subset."""
    actors, emotions, statements = set(), set(), set()
    for file_path in files:
        metadata = parse_ravdess_metadata(file_path)
        if metadata is None:
            continue
        actors.add(metadata.actor_id)
        emotions.add(metadata.emotion_code)
        statements.add(metadata.statement_code)
    return {"actors": len(actors), "emotions": len(emotions), "statements": len(statements)}


def collect_reference_samples(
    files: Sequence[str | Path],
    *,
    limit: int | None = None,
    sampling_strategy: str = "stratified",
    random_seed: int = 42,
) -> list[tuple[str, str]]:
    """(audio_path, reference_text) pairs for files with known transcripts."""
    if limit is not None and limit <= 0:
        raise ValueError("limit must be positive when provided.")
    references = [
        path
        for path in sorted(Path(f) for f in files)
        if ravdess_reference_text(path) is not None
    ]
    if limit is not None:
        if sampling_strategy == "head":
            references = references[:limit]
        elif sampling_strategy == "stratified":
            references = stratified_reference_subset(
                references, limit=limit, random_seed=random_seed
            )
        else:
            raise ValueError("sampling_strategy must be one of: 'stratified', 'head'.")
    return [(str(path), ravdess_reference_text(path) or "") for path in references]


def normalize_calibration_profile_csv(raw_profiles: str) -> tuple[str, ...]:
    """Comma-separated profile names → validated, deduplicated tuple."""
    parsed = []
    for token in raw_profiles.split(","):
        normalized = token.strip().lower()
        if not normalized:
            continue
        if normalized not in VALID_CALIBRATION_PROFILES:
            raise ValueError(f"Unsupported profile in calibration set: {token!r}.")
        parsed.append(normalized)
    if not parsed:
        raise ValueError("At least one calibration profile must be provided.")
    return tuple(dict.fromkeys(parsed))


# --------------------------------------------------------------------------- #
# Candidate latency-percentile matrix
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class LatencyPercentiles:
    """The full latency distribution for one candidate (seconds)."""

    mean: float
    p10: float
    p50: float
    p90: float
    p95: float
    minimum: float
    maximum: float


def latency_percentiles(latencies: Sequence[float]) -> LatencyPercentiles:
    """Nearest-rank percentile matrix (not numpy's interpolated percentiles)."""
    values = [float(v) for v in latencies]
    if not values:
        return LatencyPercentiles(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    return LatencyPercentiles(
        mean=sum(values) / len(values),
        p10=nearest_rank_percentile(values, 0.10),
        p50=nearest_rank_percentile(values, 0.50),
        p90=nearest_rank_percentile(values, 0.90),
        p95=nearest_rank_percentile(values, 0.95),
        minimum=min(values),
        maximum=max(values),
    )


@dataclass(frozen=True)
class CandidateMatrixEntry:
    """One candidate's full accuracy + latency + failure profile."""

    backend_id: str
    model_name: str
    mean_wer: float
    latency: LatencyPercentiles
    evaluated_samples: int
    failed_samples: int
    error_message: str | None = None
    coverage: dict[str, int] = field(default_factory=dict)

    @property
    def mean_accuracy(self) -> float:
        return max(0.0, 1.0 - self.mean_wer)

    def to_candidate_report(self) -> TranscriptionCandidateReport:
        """The compact report shape persisted alongside the matrix."""
        return TranscriptionCandidateReport(
            backend_id=self.backend_id,
            model_name=self.model_name,
            mean_wer=self.mean_wer,
            p50_latency_seconds=self.latency.p50,
            p95_latency_seconds=self.latency.p95,
            samples=self.evaluated_samples,
        )


def parse_calibration_profiles(raw_profiles: str) -> tuple[str, ...]:
    """Parses and validates calibration profile names from CLI input (the CSV normalizer)."""
    return normalize_calibration_profile_csv(raw_profiles)


def profile_candidate_matrix(
    transcribe: Callable[[str], list[TranscriptWord]],
    samples: list[tuple[str, str]],
    *,
    backend_id: str,
    model_name: str,
    iterations: int = 1,
) -> CandidateMatrixEntry:
    """Per-sample WER + the full latency percentile matrix for one candidate.

    The warmup call (weight load, the kernels' build; untimed) records its failure
    as the candidate's error entry rather than crashing the whole run — a
    corrupt FIRST clip or an unloadable backend both surface in the report,
    and other candidates still profile. AFTER a successful warmup,
    per-sample failures are counted, not fatal: one corrupt clip must not
    void an otherwise-informative calibration run.
    """
    if not samples:
        raise ValueError("Need at least one labeled sample to profile.")
    if iterations <= 0:
        raise ValueError("Calibration iterations must be a positive integer.")
    try:
        transcribe(samples[0][0])  # warmup (weight load + compile, untimed)
    except Exception as err:  # noqa: BLE001 - reported, not fatal to the run
        return CandidateMatrixEntry(
            backend_id=backend_id,
            model_name=model_name,
            mean_wer=1.0,
            latency=latency_percentiles([]),
            evaluated_samples=0,
            failed_samples=len(samples),
            error_message=f"warmup: {type(err).__name__}: {err}",
            coverage=summarize_subset_coverage([Path(path) for path, _ in samples]),
        )
    wers: list[float] = []
    latencies: list[float] = []
    failed = 0
    last_error: str | None = None
    # Iterations widen the latency percentile matrix (reference
    # "--calibration-iterations": runs per candidate); WER is deterministic
    # per clip, so only the first pass contributes accuracy samples.
    for iteration in range(iterations):
        for audio_path, reference in samples:
            try:
                start = time.perf_counter()
                words = transcribe(audio_path)
                latencies.append(time.perf_counter() - start)
            except Exception as err:  # noqa: BLE001 - counted, surfaced in report
                failed += 1
                last_error = f"{type(err).__name__}: {err}"
                continue
            if iteration == 0:
                wers.append(
                    word_error_rate(reference, " ".join(w.word for w in words))
                )
    return CandidateMatrixEntry(
        backend_id=backend_id,
        model_name=model_name,
        mean_wer=float(statistics.fmean(wers)) if wers else 1.0,
        latency=latency_percentiles(latencies),
        evaluated_samples=len(wers),
        failed_samples=failed,
        error_message=last_error if not wers else None,
        coverage=summarize_subset_coverage([Path(path) for path, _ in samples]),
    )


# --------------------------------------------------------------------------- #
# Accuracy gate + default recommendation (baseline-relative)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class AccuracyGate:
    """The minimum acceptable accuracy, derived from the baseline candidate."""

    baseline_mean_accuracy: float
    minimum_mean_accuracy: float
    maximum_accuracy_drop: float
    absolute_accuracy_floor: float


def derive_accuracy_gate(
    baseline: CandidateMatrixEntry,
    *,
    absolute_accuracy_floor: float = 0.70,
    maximum_accuracy_drop: float = 0.05,
) -> AccuracyGate:
    """Gate = max(absolute floor, baseline accuracy - allowed drop)."""
    return AccuracyGate(
        baseline_mean_accuracy=baseline.mean_accuracy,
        minimum_mean_accuracy=max(
            absolute_accuracy_floor, baseline.mean_accuracy - maximum_accuracy_drop
        ),
        maximum_accuracy_drop=maximum_accuracy_drop,
        absolute_accuracy_floor=absolute_accuracy_floor,
    )


@dataclass(frozen=True)
class DefaultRecommendation:
    """Which candidate should be the default, and why."""

    baseline_name: str
    recommended_name: str
    changed: bool
    reason: str
    mean_accuracy: float
    mean_latency_seconds: float
    speedup_ratio: float
    minimum_required_samples: int


def recommend_default_candidate(
    entries: Sequence[CandidateMatrixEntry],
    gate: AccuracyGate,
    *,
    minimum_speedup_ratio: float = 1.25,
    minimum_required_samples: int = 3,
) -> DefaultRecommendation:
    """Switch the default only for a faster candidate that clears the gate.

    entries[0] is the baseline. Candidates with errors, zero evaluated
    samples, sub-gate accuracy, or non-positive latency never win; among the
    rest the largest speedup >= the required ratio wins.
    """
    if not entries:
        raise ValueError("No candidates to recommend from.")
    baseline = entries[0]
    if baseline.evaluated_samples < minimum_required_samples:
        return DefaultRecommendation(
            baseline_name=baseline.model_name,
            recommended_name=baseline.model_name,
            changed=False,
            reason=(
                "Insufficient sample size for safe default changes. "
                f"Need at least {minimum_required_samples} evaluated samples."
            ),
            mean_accuracy=baseline.mean_accuracy,
            mean_latency_seconds=baseline.latency.mean,
            speedup_ratio=1.0,
            minimum_required_samples=minimum_required_samples,
        )
    selected, selected_speedup = baseline, 1.0
    for entry in entries[1:]:
        if entry.error_message is not None:
            continue
        # The sample-size floor applies to CANDIDATES too: a 1-evaluated-
        # sample fluke (11 of 12 clips failed) must not flip the default.
        if entry.evaluated_samples < minimum_required_samples:
            continue
        if entry.mean_accuracy < gate.minimum_mean_accuracy:
            continue
        if entry.latency.mean <= 0.0:
            continue
        speedup = baseline.latency.mean / entry.latency.mean
        if speedup >= minimum_speedup_ratio and speedup > selected_speedup:
            selected, selected_speedup = entry, speedup
    # Object identity, not model_name: candidates are keyed by
    # (backend_id, model_name), so a same-model win on a different backend
    # is still a change.
    if selected is baseline:
        return DefaultRecommendation(
            baseline_name=baseline.model_name,
            recommended_name=baseline.model_name,
            changed=False,
            reason=(
                "No candidate met both the accuracy gate and required speedup; "
                "keep current defaults."
            ),
            mean_accuracy=baseline.mean_accuracy,
            mean_latency_seconds=baseline.latency.mean,
            speedup_ratio=1.0,
            minimum_required_samples=minimum_required_samples,
        )
    return DefaultRecommendation(
        baseline_name=baseline.model_name,
        recommended_name=selected.model_name,
        changed=True,
        reason="Candidate met the accuracy gate and exceeded required speedup.",
        mean_accuracy=selected.mean_accuracy,
        mean_latency_seconds=selected.latency.mean,
        speedup_ratio=selected_speedup,
        minimum_required_samples=minimum_required_samples,
    )


# --------------------------------------------------------------------------- #
# Device runtime probes (device-stability recommendation)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class RuntimeCalibrationProbeStats:
    """Aggregated probe metrics for one candidate's device stability."""

    iterations: int
    successful_runs: int
    failed_runs: int
    tpu_loaded_runs: int
    tpu_completed_runs: int
    tpu_to_cpu_failover_runs: int
    hard_tpu_oom_runs: int
    mean_latency_seconds: float
    error_messages: tuple[str, ...]


def is_hard_tpu_oom(error: Exception) -> bool:
    """A device out-of-memory error (the JAX package's name; on the card, a CUDA OOM)."""
    return is_device_oom(error)


def run_runtime_calibration_probes(
    *,
    calibration_file: str,
    iterations: int,
    load_model: Callable[[], object],
    transcribe: Callable[[object, str], object],
    device_of: Callable[[object], str],
) -> RuntimeCalibrationProbeStats:
    """Iterative load→transcribe probes with device-stability accounting.

    ``device_of`` reports a model's active device (``"cuda"``/``"cpu"``)
    before and after the probe, so a mid-run move to the CPU is counted as
    ``tpu_to_cpu_failover_runs`` rather than a clean completion.
    """
    latencies: list[float] = []
    errors: list[str] = []
    successful = failed = 0
    tpu_loaded = tpu_completed = failover = hard_oom = 0
    for _ in range(iterations):
        model: object | None = None
        device_before = "cpu"
        started = time.perf_counter()
        try:
            model = load_model()
            device_before = device_of(model)
            if device_before == ACCELERATOR:
                tpu_loaded += 1
            transcribe(model, calibration_file)
            successful += 1
        except Exception as err:  # noqa: BLE001 - probe outcome accounting
            failed += 1
            errors.append(str(err))
            # A hard OOM counts whether it struck mid-transcribe (device
            # known to be the card) OR while load_model() was still placing
            # weights (model is None and device_before is the "cpu"
            # initializer) — weight placement is precisely where a too-big
            # model OOMs.
            if is_hard_tpu_oom(err) and (device_before == ACCELERATOR or model is None):
                hard_oom += 1
        else:
            device_after = device_of(model) if model is not None else device_before
            if device_before == ACCELERATOR and device_after == ACCELERATOR:
                tpu_completed += 1
            if device_before == ACCELERATOR and device_after == "cpu":
                failover += 1
            latencies.append(time.perf_counter() - started)
        finally:
            del model
    return RuntimeCalibrationProbeStats(
        iterations=iterations,
        successful_runs=successful,
        failed_runs=failed,
        tpu_loaded_runs=tpu_loaded,
        tpu_completed_runs=tpu_completed,
        tpu_to_cpu_failover_runs=failover,
        hard_tpu_oom_runs=hard_oom,
        mean_latency_seconds=statistics.fmean(latencies) if latencies else 0.0,
        error_messages=tuple(errors[:5]),
    )


def derive_runtime_recommendation(
    stats: RuntimeCalibrationProbeStats,
) -> tuple[str, str, str]:
    """(recommendation, confidence, reason) from probe stats.

    The JAX package's decision ladder and vocabulary, which the card's runs keep: hard OOMs
    or never-admitted loads → prefer_cpu; >=90% stable with zero failures →
    prefer_tpu; mixed stability with observed failovers → tpu_with_failover.
    """
    if stats.iterations <= 0:
        return ("prefer_cpu", "low", "No calibration runs were executed.")
    if stats.tpu_loaded_runs == 0:
        confidence = "high" if stats.iterations >= 2 else "medium"
        return ("prefer_cpu", confidence, "TPU runtime was never admitted at model load.")
    if stats.hard_tpu_oom_runs > 0:
        confidence = "high" if stats.hard_tpu_oom_runs >= 2 else "medium"
        return ("prefer_cpu", confidence, "Hard TPU OOM observed during calibration.")
    stability = stats.tpu_completed_runs / float(stats.iterations)
    failover_ratio = stats.tpu_to_cpu_failover_runs / float(stats.iterations)
    failure_ratio = stats.failed_runs / float(stats.iterations)
    if stability >= 0.90 and failure_ratio == 0.0:
        confidence = "high" if stats.iterations >= 3 else "medium"
        return ("prefer_tpu", confidence, "TPU runs remained stable across calibration.")
    if stability >= 0.40 and failover_ratio > 0.0:
        confidence = "medium" if stats.iterations >= 2 else "low"
        return (
            "tpu_with_failover",
            confidence,
            "TPU shows mixed stability; keep CPU failover enabled.",
        )
    confidence = "medium" if stats.iterations >= 2 else "low"
    return (
        "prefer_cpu",
        confidence,
        "TPU stability was insufficient for reliable runtime selection.",
    )


# --------------------------------------------------------------------------- #
# Workflow: matrix + gate + runtime probes → one versioned report
# --------------------------------------------------------------------------- #

CALIBRATION_REPORT_VERSION = 2


def build_calibration_report(
    entries: Sequence[CandidateMatrixEntry],
    *,
    runtime_stats: RuntimeCalibrationProbeStats | None = None,
    absolute_accuracy_floor: float = 0.70,
    maximum_accuracy_drop: float = 0.05,
    minimum_speedup_ratio: float = 1.25,
    minimum_required_samples: int = 3,
    now: Callable[[], float] = time.time,
) -> dict:
    """The full calibration payload: matrix, gate, recommendations.

    The top-level ``recommendation`` key keeps the v1 shape
    (``profiling.CalibrationRecommendation``) so admission-control readers of
    either version work unchanged; v2 adds the per-candidate latency matrix,
    the derived accuracy gate, the default-selection outcome, and the
    device-runtime recommendation.
    """
    if not entries:
        raise ValueError("No candidates to build a calibration report from.")
    gate = derive_accuracy_gate(
        entries[0],
        absolute_accuracy_floor=absolute_accuracy_floor,
        maximum_accuracy_drop=maximum_accuracy_drop,
    )
    default = recommend_default_candidate(
        entries,
        gate,
        minimum_speedup_ratio=minimum_speedup_ratio,
        minimum_required_samples=minimum_required_samples,
    )
    compat = dataclasses.replace(
        recommend_default([entry.to_candidate_report() for entry in entries]),
        generated_at_unix=now(),
    )
    payload: dict = {
        "version": CALIBRATION_REPORT_VERSION,
        "generated_at_unix": now(),
        "recommendation": compat.to_dict(),
        "candidates": [asdict(entry.to_candidate_report()) for entry in entries],
        "candidate_matrix": [asdict(entry) for entry in entries],
        "accuracy_gate": asdict(gate),
        "default_selection": asdict(default),
    }
    if runtime_stats is not None:
        recommendation, confidence, reason = derive_runtime_recommendation(runtime_stats)
        payload["runtime"] = {
            "stats": asdict(runtime_stats),
            "recommendation": recommendation,
            "confidence": confidence,
            "reason": reason,
        }
    return payload


def save_calibration_report_v2(payload: dict, path: str | Path) -> str:
    """Atomic write of the versioned report (admission reads `recommendation`)."""
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(target.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2), encoding="utf-8")
    os.replace(tmp, target)
    return str(target)


__all__ = [
    "AccuracyGate",
    "CALIBRATION_REPORT_VERSION",
    "CandidateMatrixEntry",
    "DefaultRecommendation",
    "LatencyPercentiles",
    "RavdessMetadata",
    "RuntimeCalibrationProbeStats",
    "STATEMENT_TEXT",
    "VALID_CALIBRATION_PROFILES",
    "build_calibration_report",
    "collect_reference_samples",
    "derive_accuracy_gate",
    "derive_runtime_recommendation",
    "is_hard_tpu_oom",
    "latency_percentiles",
    "normalize_calibration_profile_csv",
    "parse_ravdess_metadata",
    "parse_calibration_profiles",
    "profile_candidate_matrix",
    "ravdess_reference_text",
    "recommend_default_candidate",
    "run_runtime_calibration_probes",
    "save_calibration_report_v2",
    "stratified_reference_subset",
    "summarize_subset_coverage",
]
