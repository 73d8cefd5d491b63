"""Fast-versus-candidate profile rollout quality gate.

Counterpart of ``ser_tpu/_internal/runtime/quality_gate.py``: fits the fast
head and a candidate profile's head on the same labeled corpus with
speaker-grouped folds (the port's ``stratified_group_folds``), scores them
with the port's SER metrics (per-window rows vote per clip), then compares the
UAR/macro-F1 deltas and the candidate's temporal stability (segments per
minute, median segment duration) against ``QualityGateConfig``. The heads are
``TorchMLPClassifier``s on the settings' device.
"""


from __future__ import annotations

import json
from dataclasses import dataclass
from statistics import median

import numpy as np

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig, QualityGateConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.train.eval import stratified_group_folds
from ser_tpu_torch._internal.train.metrics import compute_ser_metrics, compute_sample_level_ser_metrics
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.runtime.schema import SegmentPrediction

logger = get_logger(__name__)


@dataclass(frozen=True)
class ProfileEvaluation:
    """Cross-fold metrics for one profile's head."""

    profile: str
    uar: float
    macro_f1: float
    folds: int


@dataclass(frozen=True)
class TemporalStability:
    """Segment-churn metrics for one profile's inference output."""

    segments_per_minute: float
    median_segment_duration_seconds: float


@dataclass(frozen=True)
class QualityGateDecision:
    """Gate verdict with the evidence that produced it."""

    promote: bool
    reasons: tuple[str, ...]
    baseline: ProfileEvaluation
    candidate: ProfileEvaluation
    candidate_stability: TemporalStability | None

    def to_json(self) -> str:
        return json.dumps(
            {
                "promote": self.promote,
                "reasons": list(self.reasons),
                "baseline": vars(self.baseline),
                "candidate": vars(self.candidate),
                "candidate_stability": (
                    vars(self.candidate_stability) if self.candidate_stability else None
                ),
            },
            indent=2,
        )


def evaluate_head_cross_folds(
    features: np.ndarray,
    labels: list[str],
    speakers: list[str],
    *,
    profile: str,
    settings: AppConfig,
    n_folds: int = 5,
    clip_ids: list[str] | None = None,
) -> ProfileEvaluation:
    """Speaker-grouped K-fold evaluation of the configured head on features.

    With ``clip_ids`` given, rows are PER-WINDOW samples (the representation
    encoder profiles actually train and predict on); test-fold windows
    majority-vote into per-clip predictions before scoring, matching the
    production evaluation path — clip-averaged features would measure a
    representation production never sees.
    """
    items = list(range(len(labels)))
    folds = stratified_group_folds(
        items,
        speaker_of=lambda i: speakers[i],
        label_of=lambda i: labels[i],
        n_folds=n_folds,
        random_state=settings.training.random_state,
    )
    device = resolve_device(settings.torch_runtime.device)
    uars, f1s = [], []
    for train_idx, test_idx in folds:
        if len({labels[i] for i in train_idx}) < 2:
            continue
        model = TorchMLPClassifier.from_config(settings.nn, device=device)
        model.max_iter = min(model.max_iter, 200)  # gate evaluation budget
        model.fit(features[train_idx], [labels[i] for i in train_idx])
        predictions = [str(p) for p in model.predict(features[test_idx])]
        if clip_ids is not None:
            metrics = compute_sample_level_ser_metrics(
                y_true=[labels[i] for i in test_idx],
                y_pred=predictions,
                sample_ids=[clip_ids[i] for i in test_idx],
            )
        else:
            metrics = compute_ser_metrics(
                y_true=[labels[i] for i in test_idx], y_pred=predictions
            )
        uars.append(metrics["uar"])
        f1s.append(metrics["macro_f1"])
    if not uars:
        raise RuntimeError("Quality gate: no evaluable folds.")
    return ProfileEvaluation(
        profile=profile,
        uar=float(np.mean(uars)),
        macro_f1=float(np.mean(f1s)),
        folds=len(uars),
    )


def clip_stability_metrics(
    segments: list[SegmentPrediction],
) -> tuple[float, list[float]]:
    """One clip's segments-per-minute rate and positive segment durations.

    The clip span is min(start)..max(end) (segments need not be sorted), the rate is
    ``len * 60 / span`` (0.0 for empty or zero-span clips), and zero/negative
    durations are excluded from the duration pool.
    """
    if not segments:
        return 0.0, []
    clip_start = min(segment.start_seconds for segment in segments)
    clip_end = max(segment.end_seconds for segment in segments)
    span = max(0.0, clip_end - clip_start)
    rate = (float(len(segments)) * 60.0) / span if span > 0.0 else 0.0
    durations = [
        duration
        for duration in (
            segment.end_seconds - segment.start_seconds for segment in segments
        )
        if duration > 0.0
    ]
    return rate, durations


def temporal_stability_of(
    segment_lists: list[list[SegmentPrediction]],
) -> TemporalStability:
    """Aggregates segment churn over a set of clips.

    The headline rate is the MEAN of per-clip rates (every evaluated clip contributes,
    empty clips as 0.0), not a pooled total/total ratio which would weight
    long clips more; the median runs over the pooled positive durations.
    """
    per_clip_rates: list[float] = []
    durations: list[float] = []
    for segments in segment_lists:
        rate, clip_durations = clip_stability_metrics(segments)
        per_clip_rates.append(rate)
        durations.extend(clip_durations)
    return TemporalStability(
        segments_per_minute=(
            float(np.mean(per_clip_rates)) if per_clip_rates else 0.0
        ),
        median_segment_duration_seconds=float(median(durations)) if durations else 0.0,
    )


def decide_quality_gate(
    *,
    baseline: ProfileEvaluation,
    candidate: ProfileEvaluation,
    candidate_stability: TemporalStability | None = None,
    config: QualityGateConfig | None = None,
) -> QualityGateDecision:
    """Applies the promotion thresholds of ``config`` (default: the environment's)."""
    config = config if config is not None else (reload_settings().quality_gate)
    reasons: list[str] = []
    promote = True

    uar_delta = candidate.uar - baseline.uar
    if uar_delta < config.min_uar_delta:
        promote = False
        reasons.append(
            f"UAR delta {uar_delta:+.4f} below threshold {config.min_uar_delta:+.4f}."
        )
    f1_delta = candidate.macro_f1 - baseline.macro_f1
    if f1_delta < config.min_macro_f1_delta:
        promote = False
        reasons.append(
            f"macro-F1 delta {f1_delta:+.4f} below threshold {config.min_macro_f1_delta:+.4f}."
        )
    if candidate_stability is not None:
        if candidate_stability.segments_per_minute > config.max_medium_segments_per_minute:
            promote = False
            reasons.append(
                f"{candidate_stability.segments_per_minute:.1f} segments/min exceeds "
                f"{config.max_medium_segments_per_minute:.1f}."
            )
        if (
            candidate_stability.median_segment_duration_seconds
            < config.min_medium_median_segment_duration_seconds
        ):
            promote = False
            reasons.append(
                f"Median segment {candidate_stability.median_segment_duration_seconds:.2f}s "
                f"below {config.min_medium_median_segment_duration_seconds:.2f}s."
            )
    if promote:
        reasons.append("All promotion thresholds met.")
    return QualityGateDecision(
        promote=promote,
        reasons=tuple(reasons),
        baseline=baseline,
        candidate=candidate,
        candidate_stability=candidate_stability,
    )


def duration_weighted_clip_label(
    segments: list[SegmentPrediction],
    *,
    unknown_label: str = "unknown",
) -> str:
    """Duration-weighted clip-level label from segment predictions.

    Each segment votes its duration (floored at 1e-6 so zero-length segments still count),
    ties break to the lexicographically smallest label, and an empty segment
    list yields ``unknown_label``.
    """
    if not segments:
        return unknown_label
    weighted: dict[str, float] = {}
    for segment in segments:
        duration = segment.end_seconds - segment.start_seconds
        weighted[segment.emotion] = weighted.get(segment.emotion, 0.0) + (
            duration if duration > 0.0 else 1e-6
        )
    return min(weighted, key=lambda label: (-weighted[label], label))


__all__ = [
    "ProfileEvaluation",
    "QualityGateDecision",
    "TemporalStability",
    "clip_stability_metrics",
    "decide_quality_gate",
    "duration_weighted_clip_label",
    "evaluate_head_cross_folds",
    "temporal_stability_of",
]
