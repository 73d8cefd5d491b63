"""Quality-gate report persistence and enforcement.

Counterpart of ``ser_tpu/_internal/runtime/quality_gate_report.py``: the same
versioned JSON report (sorted keys, two-space indent), its default path
beside the models, its atomic write (a temporary file, then a rename), and the
pass enforcement that turns a held gate into a terminal error.
"""


from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

from ser_tpu_torch._internal.runtime.quality_gate import QualityGateDecision

GATE_REPORT_SCHEMA_VERSION = 1
DEFAULT_REPORT_FILE_NAME = "profile_quality_gate_report.json"


class QualityGateFailedError(SystemExit):
    """Terminal failure raised when pass enforcement is on and the gate holds."""


def build_report_payload(
    decision: QualityGateDecision,
    *,
    corpus: str | None = None,
    candidate_profile: str | None = None,
) -> dict:
    """Versioned JSON-safe payload for one gate decision."""
    return {
        "schema_version": GATE_REPORT_SCHEMA_VERSION,
        "generated_at_unix": time.time(),
        "corpus": corpus,
        "candidate_profile": candidate_profile or decision.candidate.profile,
        "promote": decision.promote,
        "reasons": list(decision.reasons),
        "baseline": dataclasses.asdict(decision.baseline),
        "candidate": dataclasses.asdict(decision.candidate),
        "candidate_stability": (
            dataclasses.asdict(decision.candidate_stability)
            if decision.candidate_stability is not None
            else None
        ),
    }


def serialize_report_payload(payload: dict) -> str:
    """Deterministic key order + indentation (diff-able across runs)."""
    return json.dumps(payload, indent=2, sort_keys=True)


def resolve_report_output_path(
    *, output_path: str | Path | None, default_directory: Path
) -> Path:
    return (
        Path(output_path)
        if output_path is not None
        else default_directory / DEFAULT_REPORT_FILE_NAME
    )


def write_gate_report(payload: dict, output_path: Path) -> Path:
    """Atomically persists one serialized report (tmp file + rename)."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fd, staging = tempfile.mkstemp(
        prefix=".gate-report-", dir=str(output_path.parent)
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as handle:
            handle.write(serialize_report_payload(payload) + "\n")
        os.replace(staging, output_path)
    except BaseException:
        Path(staging).unlink(missing_ok=True)
        raise
    return output_path


def load_gate_report(path: str | Path) -> dict | None:
    """Loads a persisted report; None when missing or unreadable."""
    path = Path(path)
    if not path.is_file():
        return None
    try:
        payload = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
    if payload.get("schema_version") != GATE_REPORT_SCHEMA_VERSION:
        return None
    return payload


def enforce_quality_gate(decision: QualityGateDecision, *, require_pass: bool) -> None:
    """Terminal error when enforcement is on and the gate holds the rollout."""
    if not require_pass or decision.promote:
        return
    raise QualityGateFailedError(
        "Quality gate failed: " + "; ".join(decision.reasons)
    )


__all__ = [
    "DEFAULT_REPORT_FILE_NAME",
    "GATE_REPORT_SCHEMA_VERSION",
    "QualityGateFailedError",
    "build_report_payload",
    "enforce_quality_gate",
    "load_gate_report",
    "resolve_report_output_path",
    "serialize_report_payload",
    "write_gate_report",
]
