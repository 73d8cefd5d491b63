"""Doctor + startup preflight diagnostics.

Counterpart of ``ser_tpu/_internal/diagnostics/service.py``: structured
findings for the accelerator, runtime capability, media tooling,
transcription assets, model artifacts, staged encoder and separation
checkpoints, dataset registry health and (optionally) training readiness;
text/brief/json renderers; the fail policy (off → never; any BLOCKING finding
→ always; strict additionally on warning-or-higher). The port's accelerator
check lists the visible CUDA devices with their names and compute
capability: it is blocking when the settings resolve to the card and none is
visible, and INFO when the settings ask for the CPU. Its environment findings
report torch's version and CUDA version. ffmpeg's absence is a WARNING: audio
decode is in-house (WAV/FLAC).
"""


from __future__ import annotations

import json
import shutil

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.runtime.backend_hooks import build_backend_hooks
from ser_tpu_torch._internal.runtime.registry import resolve_runtime_capability
from ser_tpu_torch.diagnostics.domain import (
    DiagnosticFinding,
    DiagnosticReport,
    DiagnosticSeverity,
    PreflightMode,
)
from ser_tpu_torch.profiles import PROFILE_NAMES


def _check_accelerator(settings: AppConfig) -> DiagnosticFinding:
    """The CUDA devices torch sees, against the device the settings resolve to."""
    import torch

    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device

    try:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cards = []
        for index in range(count):
            major, minor = torch.cuda.get_device_capability(index)
            cards.append(f"{torch.cuda.get_device_name(index)} (compute capability {major}.{minor})")
    except Exception as err:  # noqa: BLE001 - a broken CUDA install is itself the finding
        return DiagnosticFinding(
            code="accelerator",
            severity=DiagnosticSeverity.ERROR,
            message=f"CUDA device enumeration failed: {err}",
            remediation=("Check the torch installation and the CUDA driver.",),
            blocking=True,
        )
    visible = f"{count} CUDA device(s) visible" + (f": {', '.join(cards)}" if cards else "")
    try:
        device = resolve_device(settings.torch_runtime.device)
    except (RuntimeError, ValueError) as err:
        return DiagnosticFinding(
            code="accelerator",
            severity=DiagnosticSeverity.ERROR,
            message=f"{visible}. {err}",
            remediation=("Run on a machine with a CUDA device, or set SER_TORCH_DEVICE=cpu.",),
            blocking=True,
        )
    return DiagnosticFinding(
        code="accelerator",
        severity=DiagnosticSeverity.INFO,
        message=f"{visible}; torch device {device}"
        + (" (asked for by the settings)." if device.type == "cpu" else "."),
    )


def _check_profiles(settings: AppConfig) -> list[DiagnosticFinding]:
    hooks = frozenset(build_backend_hooks(settings))
    findings = []
    for profile in PROFILE_NAMES:
        capability = resolve_runtime_capability(
            profile, settings=settings, available_hooks=hooks
        )
        if capability.available:
            findings.append(
                DiagnosticFinding(
                    code=f"profile.{profile}",
                    severity=DiagnosticSeverity.INFO,
                    message=f"Profile {profile} available (backend {capability.backend_id}).",
                )
            )
        else:
            # The always-on fast profile being unavailable blocks execution.
            is_fast = profile == "fast"
            findings.append(
                DiagnosticFinding(
                    code=f"profile.{profile}",
                    severity=(
                        DiagnosticSeverity.ERROR if is_fast else DiagnosticSeverity.WARNING
                    ),
                    message=f"Profile {profile} unavailable. {capability.message or ''}".strip(),
                    remediation=("Enable the profile flag or install missing modules.",),
                    blocking=is_fast,
                )
            )
    return findings


def _check_media_tooling() -> DiagnosticFinding:
    if shutil.which("ffmpeg"):
        return DiagnosticFinding(
            code="media.ffmpeg",
            severity=DiagnosticSeverity.INFO,
            message="ffmpeg found on PATH.",
        )
    return DiagnosticFinding(
        code="media.ffmpeg",
        severity=DiagnosticSeverity.WARNING,
        message="ffmpeg not found; only WAV/FLAC decoding is available.",
        remediation=("Install ffmpeg to decode non-WAV containers.",),
    )


def _check_transcription_assets(settings: AppConfig) -> DiagnosticFinding:
    root = settings.models.whisper_download_root
    try:
        has_assets = root.exists() and any(root.iterdir())
    except NotADirectoryError:
        # A stray FILE at the configured root: the doctor diagnoses broken
        # setups — it must report this, not traceback on it.
        return DiagnosticFinding(
            code="transcription.assets",
            severity=DiagnosticSeverity.WARNING,
            message=f"whisper_download_root {root} is a file, not a directory.",
            remediation=("Remove the file and stage model assets in a directory.",),
        )
    if has_assets:
        return DiagnosticFinding(
            code="transcription.assets",
            severity=DiagnosticSeverity.INFO,
            message=f"Transcription model assets present under {root}.",
        )
    return DiagnosticFinding(
        code="transcription.assets",
        severity=DiagnosticSeverity.WARNING,
        message=f"No transcription model assets found (expected Whisper weights under {root}).",
        remediation=("Pre-download Whisper weights or run with --no-transcript.",),
    )


def _check_model_artifacts(settings: AppConfig) -> DiagnosticFinding:
    if settings.models.model_file.exists():
        return DiagnosticFinding(
            code="models.fast_artifact",
            severity=DiagnosticSeverity.INFO,
            message=f"Fast-profile artifact present at {settings.models.model_file}.",
        )
    return DiagnosticFinding(
        code="models.fast_artifact",
        severity=DiagnosticSeverity.WARNING,
        message="No trained fast-profile artifact found.",
        remediation=("Run `ser --train` to fit the fast-profile head.",),
    )


def _staged_weight_finding(profile: str, settings: AppConfig) -> DiagnosticFinding:
    """Validates one profile's staged encoder checkpoint before first contact.

    HF-format checkpoints (medium wav2vec2, accurate whisper) are matched
    against config-derived tensor name/shape manifests — safetensors header
    reads only, no tensor loads (:mod:`ser_tpu_torch.models.checkpoint_audit`).
    The FunASR emotion2vec layout reports staging presence (its converter runs
    a consumed-key audit at load).
    """
    from pathlib import Path

    from ser_tpu_torch._internal.repr.encoder_backend import resolve_local_model_dir
    from ser_tpu_torch._internal.repr.encoders import resolved_model_id

    code = f"models.staged.{profile}"
    model_id = resolved_model_id(profile, settings)
    cache_root = Path(settings.models.huggingface_cache_root)
    model_dir = resolve_local_model_dir(cache_root, model_id)
    if model_dir is None and profile == "accurate-research":
        model_dir = resolve_local_model_dir(
            Path(settings.models.modelscope_cache_root), model_id
        )
    if model_dir is None:
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.WARNING,
            message=(
                f"No staged weights for {model_id!r} under {cache_root} — "
                "profile runs require staging (SER_ALLOW_RANDOM_INIT=1 covers "
                "tests/benchmarks only)."
            ),
            remediation=(f"Stage the {model_id} checkpoint under {cache_root}.",),
        )
    try:
        if profile == "accurate-research":
            # FunASR/data2vec layout (emotion2vec family): the structure is
            # inferred from the state dict itself, so the converter's
            # consumed-key audit (emotion2vec_convert) IS the validation —
            # doctor reports staging presence.
            return DiagnosticFinding(
                code=code,
                severity=DiagnosticSeverity.INFO,
                message=(
                    f"Staged checkpoint for {model_id!r} at {model_dir} "
                    "(emotion2vec layout is audited at load)."
                ),
            )
        from ser_tpu_torch.models.checkpoint_audit import read_checkpoint_shapes

        shapes = read_checkpoint_shapes(model_dir)
        if profile == "medium":
            from ser_tpu_torch.models import wav2vec2
            from ser_tpu_torch.models.checkpoint_audit import wav2vec2_manifest

            manifest = wav2vec2_manifest(wav2vec2.config_from_hf_dir(model_dir))
        else:
            from ser_tpu_torch.models.checkpoint_audit import whisper_manifest
            from ser_tpu_torch.models.whisper import whisper_config_from_hf_dir

            manifest = whisper_manifest(
                whisper_config_from_hf_dir(model_dir), component="model"
            )
        validation = manifest.validate(shapes)
    except (OSError, ValueError, KeyError) as err:
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.WARNING,
            message=f"Staged checkpoint at {model_dir} unreadable: {err}",
            remediation=("Re-stage the checkpoint; it appears corrupt.",),
        )
    if validation.ok:
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.INFO,
            message=(
                f"Staged weights for {model_id!r} at {model_dir} match the "
                f"expected {manifest.model} manifest ({len(shapes)} tensors)."
            ),
        )
    return DiagnosticFinding(
        code=code,
        severity=DiagnosticSeverity.WARNING,
        message=(
            f"Staged weights for {model_id!r} at {model_dir} do not match the "
            f"expected {manifest.model} layout: {validation.summary()}."
        ),
        remediation=(
            "Verify the staged checkpoint is the published model (layout "
            "variants are refused at load).",
        ),
    )


def _check_staged_encoder_weights(settings: AppConfig) -> list[DiagnosticFinding]:
    """Staged-weight readiness per encoder profile (medium/accurate/research)."""
    findings = [
        _staged_weight_finding(profile, settings)
        for profile in ("medium", "accurate", "accurate-research")
    ]
    finding = _check_separation_checkpoint(settings)
    if finding is not None:
        findings.append(finding)
    return findings


def _check_separation_checkpoint(settings: AppConfig) -> DiagnosticFinding | None:
    """Validates a configured demucs separation checkpoint before first use.

    A converted ``.npz`` validates by loading its config header (the layout
    was already audited at conversion); a raw ``.th`` validates its recorded
    constructor kwargs against what the forward implements and its tensor
    shapes against the config-derived manifest. No configured path → no
    finding (the weight-free REPET-SIM lane needs nothing staged).
    """
    path = settings.transcription.separation_model_path
    if path is None:
        return None
    from pathlib import Path

    code = "models.staged.separation"
    path = Path(path)
    if not path.exists():
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.WARNING,
            message=(
                f"Configured separation checkpoint {path} does not exist; the "
                "use_demucs lane will fall back to REPET-SIM."
            ),
            remediation=("Stage the converted demucs checkpoint at that path.",),
        )
    try:
        from ser_tpu_torch.models.demucs_v4 import is_demucs_npz, load_demucs_npz

        if is_demucs_npz(path):
            _, config = load_demucs_npz(path)
            return DiagnosticFinding(
                code=code,
                severity=DiagnosticSeverity.INFO,
                message=(
                    f"Converted demucs checkpoint staged at {path} "
                    f"(depth {config.depth}, {len(config.sources)} sources)."
                ),
            )
        if path.suffix == ".th":
            from ser_tpu_torch.models.checkpoint_audit import demucs_manifest
            import pickle

            import torch

            from ser_tpu_torch.models.demucs_v4 import config_from_checkpoint_kwargs

            try:
                package = torch.load(str(path), map_location="cpu", weights_only=True)
            except pickle.UnpicklingError:
                # A published htdemucs package pickles its model class beside the weights.
                package = torch.load(str(path), map_location="cpu", weights_only=False)
            if not (isinstance(package, dict) and "state" in package):
                raise ValueError("not a published demucs package (no 'state')")
            config = config_from_checkpoint_kwargs(dict(package.get("kwargs") or {}))
            shapes = {
                name: tuple(tensor.shape) for name, tensor in package["state"].items()
            }
            validation = demucs_manifest(config).validate(shapes)
            if validation.ok:
                return DiagnosticFinding(
                    code=code,
                    severity=DiagnosticSeverity.INFO,
                    message=(
                        f"Raw demucs .th checkpoint at {path} matches the "
                        f"expected layout ({len(shapes)} tensors); convert it "
                        "with demucs_v4.convert_demucs_checkpoint for the lane."
                    ),
                )
            return DiagnosticFinding(
                code=code,
                severity=DiagnosticSeverity.WARNING,
                message=(
                    f"Demucs checkpoint at {path} does not match the expected "
                    f"layout: {validation.summary()}."
                ),
                remediation=("Verify it is the published htdemucs artifact.",),
            )
        from ser_tpu_torch.models.separation import load_separator_params

        load_separator_params(path)
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.INFO,
            message=f"In-house separator checkpoint staged at {path}.",
        )
    except Exception as err:  # noqa: BLE001 - doctor reports, never crashes
        return DiagnosticFinding(
            code=code,
            severity=DiagnosticSeverity.WARNING,
            message=f"Separation checkpoint at {path} unreadable: {err}",
            remediation=("Re-stage or re-convert the checkpoint.",),
        )


def _check_dataset_registry(settings: AppConfig) -> DiagnosticFinding:
    from ser_tpu_torch._internal.data.registry import audit_registry_health

    issues = audit_registry_health(settings=settings)
    if not issues:
        return DiagnosticFinding(
            code="data.registry",
            severity=DiagnosticSeverity.INFO,
            message="Dataset registry healthy.",
        )
    detail = "; ".join(issue.message for issue in issues[:5])
    return DiagnosticFinding(
        code="data.registry",
        severity=DiagnosticSeverity.WARNING,
        message=f"Dataset registry has {len(issues)} issue(s): {detail}",
        remediation=("Run `ser data prepare` or repair the registry entries.",),
    )


def run_doctor_diagnostics(
    *,
    settings: AppConfig,
    include_transcription_checks: bool = True,
    include_training_readiness: bool = False,
    include_noise_findings: bool = False,
) -> DiagnosticReport:
    """Runs the full doctor check suite (optionally + training readiness).

    ``include_noise_findings`` adds INFO-level environment details (torch's
    and CUDA's versions, the native audio library's availability, the visible
    devices) that are diagnostic context, not problems.
    """
    findings: list[DiagnosticFinding] = [_check_accelerator(settings)]
    findings.extend(_check_profiles(settings))
    findings.append(_check_media_tooling())
    if include_transcription_checks:
        findings.append(_check_transcription_assets(settings))
    findings.append(_check_model_artifacts(settings))
    findings.extend(_check_staged_encoder_weights(settings))
    findings.append(_check_dataset_registry(settings))
    if include_training_readiness:
        findings.extend(_check_training_readiness(settings))
    if include_noise_findings:
        findings.extend(_noise_findings())
    return DiagnosticReport(findings=tuple(findings))


def _noise_findings() -> list[DiagnosticFinding]:
    """INFO-level environment-noise findings (versions, the native audio library, devices)."""
    import torch

    findings = [
        DiagnosticFinding(
            code="environment.torch",
            severity=DiagnosticSeverity.INFO,
            message=f"torch {torch.__version__}",
        ),
        DiagnosticFinding(
            code="environment.cuda",
            severity=DiagnosticSeverity.INFO,
            message=(
                f"CUDA {torch.version.cuda}" if torch.version.cuda else "torch built without CUDA"
            ),
        ),
    ]
    try:
        from ser_tpu_torch._internal.utils import native_audio

        findings.append(
            DiagnosticFinding(
                code="environment.native_audio",
                severity=DiagnosticSeverity.INFO,
                message=(
                    "native C++ audio decoder available"
                    if native_audio.native_decoder_available()
                    else "native C++ audio decoder unavailable (numpy fallback)"
                ),
            )
        )
    except Exception:  # noqa: BLE001 - noise lane must never fail doctor
        pass
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    findings.append(
        DiagnosticFinding(
            code="environment.devices",
            severity=DiagnosticSeverity.INFO,
            message=f"{count + 1} device(s), platforms={['cpu'] + (['cuda'] if count else [])}",
        )
    )
    return findings


def _check_training_readiness(settings: AppConfig) -> list[DiagnosticFinding]:
    """Full readiness run surfaced as doctor findings."""
    from ser_tpu_torch._internal.models.training_readiness import run_training_readiness

    try:
        report = run_training_readiness(settings=settings, profile="fast")
    except Exception as err:  # noqa: BLE001 - readiness crash is itself a finding
        return [
            DiagnosticFinding(
                code="training.readiness",
                severity=DiagnosticSeverity.ERROR,
                message=f"Training readiness crashed: {err}",
                blocking=True,
            )
        ]
    severity = (
        DiagnosticSeverity.ERROR
        if report.blocking
        else (DiagnosticSeverity.WARNING if report.findings else DiagnosticSeverity.INFO)
    )
    detail = "; ".join(f.message for f in report.findings[:5])
    return [
        DiagnosticFinding(
            code="training.readiness",
            severity=severity,
            message=(
                f"Readiness: usable={len(report.usable_files)} "
                f"quarantined={len(report.quarantined_files)} blocking={report.blocking}."
                + (f" {detail}" if detail else "")
            ),
            blocking=report.blocking,
        )
    ]


def run_startup_preflight(
    *,
    settings: AppConfig,
    include_transcription_checks: bool,
) -> DiagnosticReport:
    """Lighter preflight used by the CLI gate before inference."""
    findings: list[DiagnosticFinding] = [_check_accelerator(settings)]
    findings.extend(_check_profiles(settings))
    if include_transcription_checks:
        findings.append(_check_transcription_assets(settings))
    findings.append(_check_model_artifacts(settings))
    return DiagnosticReport(findings=tuple(findings))


def render_report(report: DiagnosticReport, *, style: str = "text") -> str:
    """Renders one report as text, brief, or json.

    JSON is ``report.to_dict()`` with sorted keys — summary counts +
    per-finding code/severity/message/blocking/remediation.
    """
    if style == "json":
        return json.dumps(report.to_dict(), indent=2, sort_keys=True)
    if style == "text":
        # Header + severity counts, [LEVEL] code: status message, remediation lines.
        counts = report.counts_by_severity()
        lines = [
            "SER diagnostics report",
            f"summary: info={counts['info']} warning={counts['warning']} error={counts['error']}",
        ]
        if not report.findings:
            lines.append("status: ok (no findings)")
            return "\n".join(lines)
        for finding in report.findings:
            level = finding.severity.value.upper()
            status_label = (
                " blocking"
                if finding.blocking
                else (
                    " advisory"
                    if finding.severity is DiagnosticSeverity.WARNING
                    else (
                        " informational"
                        if finding.severity is DiagnosticSeverity.INFO
                        else ""
                    )
                )
            )
            lines.append(f"[{level}] {finding.code}:{status_label} {finding.message}")
            for remediation in finding.remediation:
                lines.append(f"  remediation: {remediation}")
        return "\n".join(lines)
    icons = {
        DiagnosticSeverity.INFO: "ok",
        DiagnosticSeverity.WARNING: "warn",
        DiagnosticSeverity.ERROR: "FAIL",
    }
    lines = []
    for finding in report.findings:
        if finding.severity is DiagnosticSeverity.INFO:
            continue
        lines.append(f"[{icons[finding.severity]:>4}] {finding.code}: {finding.message}")
    return "\n".join(lines) if lines else "All checks passed."


def preflight_should_abort(report: DiagnosticReport, mode: PreflightMode) -> bool:
    """Fail policy: ``off`` never aborts; any BLOCKING finding always aborts;
    ``strict`` additionally aborts on warning-or-higher."""
    if mode == "off":
        return False
    if report.has_blocking_findings:
        return True
    return mode == "strict" and report.has_warning_or_higher


def should_fail_preflight(*, report: DiagnosticReport, mode: PreflightMode) -> bool:
    """Keyword-argument alias of :func:`preflight_should_abort`."""
    return preflight_should_abort(report, mode)


__all__ = [
    "preflight_should_abort",
    "render_report",
    "run_doctor_diagnostics",
    "run_startup_preflight",
    "should_fail_preflight",
]
