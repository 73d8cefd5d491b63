"""Transcription backend adapter contract.

Counterpart of ``ser_tpu/_internal/transcript/base.py``: the adapter protocol
(check_compatibility / setup_required / prepare_assets / load_model /
transcribe), ``CompatibilityReport`` with functional/operational/noise issue
tiers, and ``BackendRuntimeRequest`` describing the runtime the adapter needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

from ser_tpu_torch.domain import TranscriptWord


@dataclass(frozen=True)
class CompatibilityIssue:
    """One compatibility finding; ``blocking`` issues prevent transcription."""

    kind: str  # "functional" | "operational" | "noise"
    message: str
    blocking: bool = False


@dataclass(frozen=True)
class CompatibilityReport:
    """Outcome of one adapter compatibility check."""

    issues: tuple[CompatibilityIssue, ...] = field(default_factory=tuple)

    @property
    def blocking(self) -> bool:
        return any(issue.blocking for issue in self.issues)


@dataclass(frozen=True)
class BackendRuntimeRequest:
    """Runtime requirements one adapter asks the host to satisfy."""

    model_name: str
    use_demucs: bool = False
    use_vad: bool = True
    device: str = "auto"
    precision_candidates: tuple[str, ...] = ("bfloat16", "float32")
    memory_tier: str = "standard"  # "low" | "standard" | "high"


@runtime_checkable
class TranscriptionBackendAdapter(Protocol):
    """Adapter protocol every transcription backend implements."""

    @property
    def backend_id(self) -> str: ...

    def check_compatibility(self) -> CompatibilityReport:
        """Environment/asset compatibility findings for this adapter."""
        ...

    def setup_required(self) -> bool:
        """True when prepare_assets/load_model must run before transcribe."""
        ...

    def prepare_assets(self) -> None:
        """Stages any local assets the backend needs."""
        ...

    def load_model(self, request: BackendRuntimeRequest) -> None:
        """Loads the transcription model per the runtime request."""
        ...

    def transcribe(self, file_path: str, *, language: str) -> list[TranscriptWord]:
        """Transcribes one file to word-level timestamps."""
        ...


__all__ = [
    "BackendRuntimeRequest",
    "CompatibilityIssue",
    "CompatibilityReport",
    "TranscriptionBackendAdapter",
]
