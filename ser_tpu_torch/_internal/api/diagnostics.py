"""Internal diagnostics API (counterpart of ``ser_tpu/_internal/api/diagnostics.py``)."""

from __future__ import annotations

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.diagnostics import service
from ser_tpu_torch.diagnostics.domain import DiagnosticReport


def run_startup_preflight(
    *, settings: AppConfig, include_transcription_checks: bool
) -> DiagnosticReport:
    """Structured startup diagnostics for the active settings snapshot."""
    return service.run_startup_preflight(
        settings=settings, include_transcription_checks=include_transcription_checks
    )


def run_doctor_diagnostics(
    *, settings: AppConfig, include_transcription_checks: bool = True
) -> DiagnosticReport:
    """Full doctor diagnostics."""
    return service.run_doctor_diagnostics(
        settings=settings, include_transcription_checks=include_transcription_checks
    )


__all__ = ["run_doctor_diagnostics", "run_startup_preflight"]
