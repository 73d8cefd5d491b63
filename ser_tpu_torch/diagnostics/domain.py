"""Diagnostics domain types (copied from ``ser_tpu/diagnostics/domain.py``).

Field names, report properties, the severity values and the ``to_dict`` JSON
shape are the JAX package's: ``finding.code`` / ``finding.blocking`` and the
``summary.counts`` payload are read by downstream tooling.
"""


from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Literal

type PreflightMode = Literal["off", "warn", "strict"]


class DiagnosticSeverity(str, Enum):
    """Severity levels for diagnostic findings (members compare equal to their string values)."""

    INFO = "info"
    WARNING = "warning"
    ERROR = "error"


@dataclass(frozen=True)
class DiagnosticFinding:
    """Represents one actionable diagnostic finding."""

    code: str
    severity: DiagnosticSeverity
    message: str
    remediation: tuple[str, ...] = ()
    blocking: bool = False


@dataclass(frozen=True)
class DiagnosticReport:
    """Aggregates findings produced by one diagnostics execution."""

    findings: tuple[DiagnosticFinding, ...] = ()

    @property
    def has_blocking_findings(self) -> bool:
        """Returns whether any finding requires failing execution."""
        return any(finding.blocking for finding in self.findings)

    @property
    def has_warning_or_higher(self) -> bool:
        """Returns whether any warning or error finding exists."""
        return any(
            finding.severity in (DiagnosticSeverity.WARNING, DiagnosticSeverity.ERROR)
            for finding in self.findings
        )

    @property
    def has_error(self) -> bool:
        """Returns whether any error finding exists."""
        return any(
            finding.severity is DiagnosticSeverity.ERROR for finding in self.findings
        )

    def counts_by_severity(self) -> dict[str, int]:
        """Returns one severity-count index for report summarization."""
        counts: dict[str, int] = {"info": 0, "warning": 0, "error": 0}
        for finding in self.findings:
            counts[finding.severity.value] += 1
        return counts

    def findings_for(self, severity: DiagnosticSeverity) -> tuple[DiagnosticFinding, ...]:
        return tuple(f for f in self.findings if f.severity is severity)

    def to_dict(self) -> dict[str, object]:
        """Returns one JSON-serializable report payload."""
        return {
            "summary": {
                "counts": self.counts_by_severity(),
                "has_blocking_findings": self.has_blocking_findings,
                "has_warning_or_higher": self.has_warning_or_higher,
                "has_error": self.has_error,
            },
            "findings": [
                {
                    "code": finding.code,
                    "severity": finding.severity.value,
                    "message": finding.message,
                    "blocking": finding.blocking,
                    "remediation": list(finding.remediation),
                }
                for finding in self.findings
            ],
        }


__all__ = ["DiagnosticFinding", "DiagnosticReport", "DiagnosticSeverity", "PreflightMode"]
