"""Device-memory admission control for transcription model loads.

Counterpart of ``ser_tpu/_internal/transcript/hbm_admission.py``: before
loading a transcription model, estimate its device footprint and compare it
with free device memory plus headroom and safety margins, honouring a fresh
calibration report that proves the model runs here. The device is the CUDA
card (``torch.cuda.mem_get_info``); on the CPU there is no device memory to
account and the check admits, as the JAX package does without memory stats.

The calibration report's loader is a copy of the one reader this needs from
``ser_tpu/_internal/transcript/profiling.py``; the calibration workflow that
writes reports is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ser_tpu_torch._internal.config.schema import TranscriptionConfig

logger = logging.getLogger(__name__)

#: Rough parameter counts (millions) per Whisper model name.
_MODEL_PARAMS_M: dict[str, float] = {
    "tiny": 39,
    "base": 74,
    "small": 244,
    "medium": 769,
    "large": 1550,
    "large-v2": 1550,
    "large-v3": 1550,
    "turbo": 809,
    "distil-large-v3": 756,
}


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one admission check."""

    admitted: bool
    reason: str
    estimated_footprint_mb: float
    free_memory_mb: float | None


@dataclass(frozen=True)
class CalibrationRecommendation:
    """A persisted calibration recommendation (the report's ``recommendation``)."""

    backend_id: str
    model_name: str
    confidence: str  # "high" | "medium" | "low"
    mean_wer: float
    p50_latency_seconds: float
    generated_at_unix: float


def load_calibration_report(path: str | Path) -> CalibrationRecommendation | None:
    """Loads a persisted recommendation; None when missing or unreadable."""
    target = Path(path)
    if not target.exists():
        return None
    try:
        raw = json.loads(target.read_text(encoding="utf-8"))["recommendation"]
        report = CalibrationRecommendation(**raw)
        if report.confidence not in ("high", "medium", "low"):
            raise TypeError(f"invalid confidence {report.confidence!r}")
        float(report.generated_at_unix)
        float(report.mean_wer)
        return report
    except (OSError, KeyError, TypeError, ValueError) as err:
        logger.warning("Unreadable calibration report %s: %s", path, err)
        return None


def default_calibration_report_path(tmp_folder) -> Path:
    """The calibration writer's default report location (shared with admission)."""
    return Path(tmp_folder) / "transcription_calibration.json"


def estimate_model_footprint_mb(model_name: str) -> float:
    """Estimated device footprint in MB: bf16 weights and about 1.5x for activations and caches.

    English-only and org-prefixed names normalize to their base size; an
    unknown name counts as large (deny before running out of memory).
    """
    name = model_name.lower().strip()
    name = name.rsplit("/", 1)[-1].removeprefix("whisper-")
    name = name.removesuffix(".en")
    params_m = _MODEL_PARAMS_M.get(name, 1550.0)
    return params_m * 2.0 * 2.5


def device_free_memory_mb() -> float | None:
    """Free memory of the current CUDA device in MB; None without a card."""
    if not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info()
    return free / (1024 * 1024)


def calibration_admission_override(
    model_name: str, config: TranscriptionConfig, *, default_report_path=None
) -> str | None:
    """The admit reason a fresh, confident calibration report for this model gives, else None."""
    if not config.calibration_overrides_enabled:
        return None
    report_path = config.calibration_report_path or default_report_path
    if report_path is None:
        return None
    report = load_calibration_report(report_path)
    if report is None or report.model_name != model_name:
        return None
    age_hours = (time.time() - report.generated_at_unix) / 3600.0
    if age_hours > config.calibration_report_max_age_hours:
        return None
    rank = {"low": 0, "medium": 1, "high": 2}
    if rank[report.confidence] < rank.get(config.calibration_min_confidence, 2):
        return None
    return (
        f"calibration report confirms {model_name!r} runs here "
        f"(confidence={report.confidence}, wer={report.mean_wer:.3f})"
    )


def admit_transcription_model(
    model_name: str, *, config: TranscriptionConfig, default_report_path=None
) -> AdmissionDecision:
    """Whether loading ``model_name`` fits in device memory.

    A valid calibration override waives the headroom and safety margins, but
    never the live free-memory check.
    """
    footprint = estimate_model_footprint_mb(model_name)
    if not config.hbm_admission_control_enabled:
        return AdmissionDecision(True, "admission control disabled", footprint, None)
    override = calibration_admission_override(model_name, config, default_report_path=default_report_path)
    free = device_free_memory_mb()
    if free is None:
        return AdmissionDecision(True, override or "device memory stats unavailable; admitting", footprint, None)
    margins = 0.0 if override else config.hbm_admission_min_headroom_mb + config.hbm_admission_safety_margin_mb
    required = footprint + margins
    if free >= required:
        reason = (
            f"{override}; {free:.0f} MB free >= {required:.0f} MB footprint"
            if override
            else f"{free:.0f} MB free >= {required:.0f} MB required"
        )
        return AdmissionDecision(True, reason, footprint, free)
    return AdmissionDecision(
        False,
        f"{free:.0f} MB free < {required:.0f} MB required for {model_name!r}; "
        "choose a smaller transcription model or free device memory.",
        footprint,
        free,
    )


__all__ = [
    "AdmissionDecision",
    "CalibrationRecommendation",
    "admit_transcription_model",
    "calibration_admission_override",
    "default_calibration_report_path",
    "device_free_memory_mb",
    "estimate_model_footprint_mb",
    "load_calibration_report",
]
