"""Public diagnostics domain types."""

from ser_tpu_torch.diagnostics.domain import (
    DiagnosticFinding,
    DiagnosticReport,
    DiagnosticSeverity,
    PreflightMode,
)

__all__ = ["DiagnosticFinding", "DiagnosticReport", "DiagnosticSeverity", "PreflightMode"]
