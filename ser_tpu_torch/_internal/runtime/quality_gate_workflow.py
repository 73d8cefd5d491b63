"""Quality-gate workflow: evaluate, decide, persist, enforce.

Counterpart of ``ser_tpu/_internal/runtime/quality_gate_workflow.py``: the
fast baseline and a candidate profile evaluated on the labeled corpus
(``SER_DATASET_FOLDER``) with speaker-grouped folds, the candidate's temporal
stability measured through its backend hook when it has one (a trained
artifact), the versioned report persisted and the promote/hold verdict
enforced. On the card the candidate's encode runs its kernels (K1 and K2 for
``accurate``, masked K2 for ``medium``) through ``encode_clips``, and so do
the stability requests.
"""


from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models.noise_controls import apply_noise_controls
from ser_tpu_torch._internal.runtime.quality_gate import (
    QualityGateDecision,
    decide_quality_gate,
    evaluate_head_cross_folds,
    temporal_stability_of,
)
from ser_tpu_torch._internal.runtime.quality_gate_report import (
    QualityGateFailedError,
    build_report_payload,
    enforce_quality_gate,
    resolve_report_output_path,
    write_gate_report,
)
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)


def evaluate_candidate_gate(
    *,
    settings: AppConfig,
    candidate: str,
    folds: int = 4,
    stability_clips: int = 6,
    stability_corpus: list[tuple[str, str]] | None = None,
) -> QualityGateDecision:
    """Runs both profile evaluations and returns the gate decision.

    ``stability_corpus`` — optional (file_path, label) pairs measured INSTEAD
    of the first training clips for temporal stability. The stability check
    exists to catch label churn on LONG audio; a corpus of uniform short clips
    yields one segment per clip and constant metrics no candidate can fail, so
    callers building discriminative evidence pass long transition clips here.
    A failure of the stability pass is logged and leaves
    ``candidate_stability`` None, as in the JAX package.
    """
    from ser_tpu_torch._internal.data import loader
    from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
    from ser_tpu_torch._internal.repr.encoders import build_encoder_backend
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file

    clips = loader.load_labeled_clips(settings=settings)
    if len(clips) < 8:
        raise RuntimeError(
            "Quality gate needs a labeled corpus of at least 8 clips "
            "(SER_DATASET_FOLDER)."
        )
    labels = [clip.label for clip in clips]
    speakers = [clip.speaker_id or clip.file_path for clip in clips]

    fast_features = np.asarray([clip.features for clip in clips], dtype=np.float64)
    baseline = evaluate_head_cross_folds(
        fast_features, labels, speakers, profile="fast", settings=settings, n_folds=folds
    )

    backend = build_encoder_backend(candidate, settings)
    runtime = settings.profile_runtime(candidate)  # type: ignore[arg-type]
    from ser_tpu_torch._internal.repr.encode_util import encode_clips

    # PER-WINDOW candidate rows with the production noise controls — the
    # representation encoder profiles actually train/predict on (clip-mean
    # features would gate on something production never computes). Decode
    # and encode in bounded chunks: the clips were already decoded once by
    # the loader, and holding the whole corpus PCM again is pure waste.
    min_std = settings.medium_training.min_window_std
    max_windows = settings.medium_training.max_windows_per_clip
    window_rows: list[np.ndarray] = []
    window_labels: list[str] = []
    window_speakers: list[str] = []
    window_clips: list[str] = []
    chunk_size = 64
    for chunk_start in range(0, len(clips), chunk_size):
        chunk = clips[chunk_start : chunk_start + chunk_size]
        decoded = [
            read_audio_file(clip.file_path, audio_read_config=settings.audio_read)
            for clip in chunk
        ]
        for clip, sequence in zip(chunk, encode_clips(backend, decoded)):
            windows = temporal_pooling_windows(
                sequence,
                window_size_seconds=runtime.pool_window_size_seconds,
                window_stride_seconds=runtime.pool_window_stride_seconds,
            )
            pooled = mean_std_pool(sequence, windows)
            kept_rows, _, _ = apply_noise_controls(
                pooled, min_window_std=min_std, max_windows_per_clip=max_windows
            )
            for row in kept_rows:
                window_rows.append(row)
                window_labels.append(clip.label)
                window_speakers.append(clip.speaker_id or clip.file_path)
                window_clips.append(clip.file_path)
    if not window_rows:
        raise RuntimeError("Quality gate: no candidate windows survived noise controls.")
    candidate_eval = evaluate_head_cross_folds(
        np.asarray(window_rows, dtype=np.float64),
        window_labels,
        window_speakers,
        profile=candidate,
        settings=settings,
        n_folds=folds,
        clip_ids=window_clips,
    )

    stability = None
    try:
        from ser_tpu_torch._internal.runtime.backend_hooks import build_backend_hooks
        from ser_tpu_torch.profiles import require_ported
        from ser_tpu_torch.runtime.contracts import InferenceRequest

        hooks = build_backend_hooks(settings)
        backend_id = require_ported(candidate).backend_id
        if backend_id in hooks:
            if stability_corpus is not None:
                stability_sample = list(stability_corpus)
            else:
                stability_sample = [
                    (clip.file_path, clip.label) for clip in clips[:stability_clips]
                ]
            segment_lists = [
                hooks[backend_id](
                    InferenceRequest(file_path=file_path, language="en")
                ).segments
                for file_path, _ in stability_sample
            ]
            stability = temporal_stability_of(segment_lists)
            # Full-pipeline agreement over the stability sample, by
            # duration-weighted segment vote; recorded as evidence.
            from ser_tpu_torch._internal.runtime.quality_gate import (
                duration_weighted_clip_label,
            )

            agreement = [
                duration_weighted_clip_label(segments) == label
                for (_, label), segments in zip(stability_sample, segment_lists)
            ]
            if agreement:
                logger.info(
                    "Full-pipeline clip agreement (duration-weighted vote): %d/%d",
                    sum(agreement),
                    len(agreement),
                )
    except Exception as err:  # noqa: BLE001 - stability is optional evidence
        logger.info("Temporal stability unavailable: %s", err)

    return decide_quality_gate(
        baseline=baseline,
        candidate=candidate_eval,
        candidate_stability=stability,
        config=settings.quality_gate,
    )


def run_quality_gate_workflow(
    *,
    settings: AppConfig,
    candidate: str,
    folds: int = 4,
    output_path: str | Path | None = None,
    require_pass: bool = False,
) -> int:
    """Full gate run with persisted report.

    Exit codes: 0 = promote (or an advisory hold without ``require_pass``);
    1 = hold under ``require_pass``; 2 = unusable corpus/config.
    """
    try:
        decision = evaluate_candidate_gate(
            settings=settings, candidate=candidate, folds=folds
        )
    except (RuntimeError, OSError, ValueError, KeyError) as err:
        # Missing/corrupt clips, bad candidate names, degenerate encodes —
        # all input defects → the documented clean exit 2, not a traceback.
        print(str(err), file=sys.stderr)
        return 2
    payload = build_report_payload(
        decision,
        corpus=str(settings.dataset.folder),
        candidate_profile=candidate,
    )
    target = resolve_report_output_path(
        output_path=output_path, default_directory=settings.models.folder
    )
    written = write_gate_report(payload, target)
    print(f"quality-gate report: {written}")
    for reason in decision.reasons:
        print(f"  - {reason}")
    print(f"verdict: {'PROMOTE' if decision.promote else 'HOLD'} {candidate}")
    try:
        enforce_quality_gate(decision, require_pass=require_pass)
    except QualityGateFailedError as err:
        print(str(err), file=sys.stderr)
        return 1
    # Without require_pass a HOLD is advisory (report written, verdict
    # printed, exit 0) — otherwise the flag would change nothing, and CI
    # authors reading the --require-pass help would be misled.
    return 0 if (decision.promote or not require_pass) else 1


__all__ = ["evaluate_candidate_gate", "run_quality_gate_workflow"]
