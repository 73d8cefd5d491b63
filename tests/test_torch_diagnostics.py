"""The port's doctor and startup preflight against ``ser_tpu``'s, on the CPU.

Both packages diagnose the same tmp roots (the same environment dict): empty
roots; a staged tiny Whisper checkpoint (safetensors) whose tensors match the
manifest, one that misses a tensor, a corrupt medium checkpoint, a FunASR
``model.pt``, the fast artifact, a registered dataset whose root is gone, a
missing and a staged U-Net separation checkpoint; the doctor with training
readiness on a synthetic corpus. Held alike: each finding's code, severity and
``blocking`` flag, in order, except the named exceptions, the ``accelerator``
finding (the port lists CUDA devices against its settings' device, the JAX
package its JAX devices) and the ``environment.*`` findings (torch and CUDA
versions where the JAX package reports jax and flax); ``render_report`` in
its three styles, byte for byte, for the same report; the fail policy. The
port's accelerator finding blocks when the settings ask for the card and
none is visible.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs as jax_build
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs as jax_capture
from ser_tpu._internal.diagnostics import service as jax_service
from ser_tpu.diagnostics import domain as jax_domain
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.diagnostics import service
from ser_tpu_torch.diagnostics import domain

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from build_synthetic_ravdess_dataset import build_dataset  # noqa: E402

#: Findings each package words for its own stack.
_OWN = ("accelerator", "environment.")


def _shape(report) -> list[tuple[str, str, bool]]:
    return [(f.code, f.severity.value, f.blocking) for f in report.findings if not f.code.startswith(_OWN)]


def _write_safetensors(path: Path, shapes: dict[str, tuple[int, ...]]) -> None:
    header, offset = {}, 0
    for name, shape in shapes.items():
        size = 4 * int(np.prod(shape))
        header[name] = {"dtype": "F32", "shape": list(shape), "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + bytes(offset))


def _stage_whisper(model_dir: Path, *, drop: str | None = None) -> None:
    from ser_tpu_torch.models.checkpoint_audit import whisper_manifest
    from ser_tpu_torch.models.whisper import WhisperConfig

    config = WhisperConfig.tiny()
    (model_dir).mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps({
        "num_mel_bins": config.n_mels, "d_model": config.d_model, "encoder_layers": config.encoder_layers,
        "decoder_layers": config.decoder_layers, "encoder_attention_heads": config.n_heads,
        "vocab_size": config.vocab_size, "max_target_positions": config.max_target_positions,
    }))
    shapes = {f"model.{name}": shape for name, shape in whisper_manifest(config).required.items() if name != drop}
    _write_safetensors(model_dir / "model.safetensors", shapes)


def _env(root: Path, **extra: str) -> dict[str, str]:
    return {"SER_CACHE_DIR": str(root / "cache"), "SER_DATA_DIR": str(root / "data"), "SER_TORCH_DEVICE": "cpu",
            "SER_ACCURATE_MODEL_ID": "org/whisper-tiny", "SER_MEDIUM_MODEL_ID": "org/xlsr-tiny",
            "SER_ACCURATE_RESEARCH_MODEL_ID": "iic/e2v-tiny", **extra}


def _both(env: dict[str, str], run: str, **options):
    ours = getattr(service, run)(settings=build_settings(env), **options)
    theirs = getattr(jax_service, run)(settings=jax_build(jax_capture(env=dict(env))), **options)
    return ours, theirs


def _stage_all(root: Path) -> dict[str, str]:
    hf = root / "cache" / "model-cache" / "huggingface"
    _stage_whisper(hf / "org" / "whisper-tiny")
    medium = hf / "org" / "xlsr-tiny"
    medium.mkdir(parents=True)
    (medium / "config.json").write_text("{}")
    (medium / "model.safetensors").write_bytes(b"\x08\x00\x00\x00\x00\x00\x00\x00{corrupt")
    research = root / "cache" / "model-cache" / "modelscope" / "hub" / "iic" / "e2v-tiny"
    research.mkdir(parents=True)
    (research / "model.pt").write_bytes(b"staged")
    models = root / "data" / "models"
    models.mkdir(parents=True)
    (models / "ser_model.pkl").write_bytes(b"artifact")
    whisper_root = root / "cache" / "model-cache" / "OpenAI" / "whisper"
    whisper_root.mkdir(parents=True)
    (whisper_root / "tiny").mkdir()
    from ser_tpu_torch._internal.data.registry import DatasetRegistryRecord, register_dataset

    register_dataset(
        DatasetRegistryRecord(dataset_id="gone", dataset_root=str(root / "gone"),
                              manifest_path=str(root / "gone" / "manifest.jsonl"), utterance_count=3),
        settings=build_settings(_env(root)),
    )
    from ser_tpu_torch.models.separation import SeparatorConfig, init_separator_params, save_separator_params

    config = SeparatorConfig(n_fft=64, hop=16, channels=(4, 8), bottleneck_layers=1, bottleneck_heads=2)
    save_separator_params(init_separator_params(config, seed=0), root / "unet.npz", config=config)
    return _env(root)


@pytest.mark.parametrize("staged", ["empty", "staged"])
def test_doctor_and_preflight_match(tmp_path: Path, staged: str) -> None:
    env = _stage_all(tmp_path) if staged == "staged" else _env(tmp_path)
    for run, options in (
        ("run_doctor_diagnostics", {"include_noise_findings": True}),
        ("run_doctor_diagnostics", {"include_transcription_checks": False}),
        ("run_startup_preflight", {"include_transcription_checks": True}),
        ("run_startup_preflight", {"include_transcription_checks": False}),
    ):
        ours, theirs = _both(env, run, **options)
        assert _shape(ours) == _shape(theirs), (run, options)
        codes = [f.code for f in ours.findings]
        assert codes[0] == "accelerator" and not ours.findings[0].blocking
        if staged == "staged" and run == "run_doctor_diagnostics":
            by_code = {f.code: f for f in ours.findings}
            assert by_code["models.staged.accurate"].severity is domain.DiagnosticSeverity.INFO
            assert "unreadable" in by_code["models.staged.medium"].message
            assert by_code["data.registry"].severity is domain.DiagnosticSeverity.WARNING
        if options.get("include_noise_findings"):
            assert [c for c in codes if c.startswith("environment.")] == [
                "environment.torch", "environment.cuda", "environment.native_audio", "environment.devices"]


@pytest.mark.parametrize("case", ["missing-tensor", "separation-missing", "separation-unet"])
def test_checkpoint_findings_match(tmp_path: Path, case: str) -> None:
    env = _env(tmp_path)
    hf = tmp_path / "cache" / "model-cache" / "huggingface"
    if case == "missing-tensor":
        _stage_whisper(hf / "org" / "whisper-tiny", drop="encoder.layers.1.fc2.bias")
    elif case == "separation-missing":
        env["SER_SEPARATION_MODEL_PATH"] = str(tmp_path / "absent.npz")
    else:
        _stage_all(tmp_path)
        env["SER_SEPARATION_MODEL_PATH"] = str(tmp_path / "unet.npz")
    ours, theirs = _both(env, "run_doctor_diagnostics")
    assert _shape(ours) == _shape(theirs)
    by_code = {f.code: f for f in ours.findings}
    if case == "missing-tensor":
        staged = by_code["models.staged.accurate"]
        assert staged.severity is domain.DiagnosticSeverity.WARNING and "1 missing" in staged.message
        assert staged.message == {f.code: f for f in theirs.findings}["models.staged.accurate"].message
    else:
        expected = domain.DiagnosticSeverity.WARNING if case == "separation-missing" else domain.DiagnosticSeverity.INFO
        assert by_code["models.staged.separation"].severity is expected


def test_doctor_training_readiness_matches(tmp_path: Path) -> None:
    from ser_tpu._internal.utils import native_audio as jax_native_audio
    from ser_tpu_torch._internal.utils import native_audio

    build_dataset(tmp_path / "ds", actors=2, repetitions=1, seconds=1.0)
    env = _env(tmp_path, SER_DATASET_FOLDER=str(tmp_path / "ds"), SER_TRAINING_SMOKE_TIMEOUT_SECONDS="60")
    assert native_audio.native_decoder_available() == jax_native_audio.native_decoder_available()
    ours, theirs = _both(env, "run_doctor_diagnostics", include_training_readiness=True)
    assert _shape(ours) == _shape(theirs)
    readiness = [f for f in ours.findings if f.code == "training.readiness"]
    assert readiness and readiness[0].message == [f for f in theirs.findings if f.code == "training.readiness"][0].message


def test_accelerator_blocks_without_a_card(tmp_path: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = service.run_startup_preflight(settings=build_settings(_env(tmp_path, SER_TORCH_DEVICE="auto")),
                                           include_transcription_checks=False)
    accelerator = report.findings[0]
    assert (accelerator.code, accelerator.severity, accelerator.blocking) == (
        "accelerator", domain.DiagnosticSeverity.ERROR, True)
    assert "0 CUDA device(s) visible" in accelerator.message and "SER_TORCH_DEVICE=cpu" in accelerator.message
    assert service.preflight_should_abort(report, "warn") and not service.preflight_should_abort(report, "off")
    cpu = service.run_startup_preflight(settings=build_settings(_env(tmp_path)), include_transcription_checks=False)
    assert cpu.findings[0].severity is domain.DiagnosticSeverity.INFO and "asked for" in cpu.findings[0].message


def _jax_report(report: domain.DiagnosticReport) -> jax_domain.DiagnosticReport:
    return jax_domain.DiagnosticReport(findings=tuple(
        jax_domain.DiagnosticFinding(code=f.code, severity=jax_domain.DiagnosticSeverity(f.severity.value),
                                     message=f.message, remediation=f.remediation, blocking=f.blocking)
        for f in report.findings))


REPORTS = {
    "empty": domain.DiagnosticReport(),
    "mixed": domain.DiagnosticReport(findings=(
        domain.DiagnosticFinding("accelerator", domain.DiagnosticSeverity.INFO, "1 CUDA device(s) visible"),
        domain.DiagnosticFinding("media.ffmpeg", domain.DiagnosticSeverity.WARNING, "ffmpeg not found",
                                 remediation=("Install ffmpeg.", "Or decode WAV only.")),
        domain.DiagnosticFinding("profile.fast", domain.DiagnosticSeverity.ERROR, "unavailable", blocking=True),
        domain.DiagnosticFinding("data.registry", domain.DiagnosticSeverity.ERROR, "broken \"quoted\" ü"),
    )),
    "info-only": domain.DiagnosticReport(findings=(
        domain.DiagnosticFinding("profile.fast", domain.DiagnosticSeverity.INFO, "available"),)),
}


@pytest.mark.parametrize("name", list(REPORTS))
@pytest.mark.parametrize("style", ["text", "brief", "json"])
def test_render_and_policy_match(name: str, style: str) -> None:
    report = REPORTS[name]
    theirs = _jax_report(report)
    assert service.render_report(report, style=style) == jax_service.render_report(theirs, style=style)
    assert report.to_dict() == theirs.to_dict()
    for mode in ("off", "warn", "strict"):
        assert service.preflight_should_abort(report, mode) == jax_service.preflight_should_abort(theirs, mode)
        assert service.should_fail_preflight(report=report, mode=mode) == jax_service.should_fail_preflight(
            report=theirs, mode=mode)


def test_public_surfaces_match() -> None:
    import inspect

    import ser_tpu.api as jax_api
    import ser_tpu.diagnostics as jax_diagnostics
    import ser_tpu_torch.api as api
    import ser_tpu_torch.diagnostics as diagnostics

    assert diagnostics.__all__ == jax_diagnostics.__all__
    assert [member.value for member in domain.DiagnosticSeverity] == [
        member.value for member in jax_domain.DiagnosticSeverity]
    for name in ("list_profiles", "load_profile", "run_startup_preflight"):
        assert str(inspect.signature(getattr(api, name))) == str(inspect.signature(getattr(jax_api, name)))
    left_out = {"ComplianceMode", "DatasetConsents", "DatasetPrepareResult", "DatasetRegistryHealthIssueRecord",
                "DatasetRegistryRecord", "configure_dataset_consents", "list_dataset_registry_health_issues",
                "list_datasets", "list_registered_datasets", "prepare_dataset", "show_dataset_consents"}
    assert set(api.__all__) == set(jax_api.__all__) - left_out


def test_api_diagnostics_match(tmp_path: Path) -> None:
    import ser_tpu.api as jax_api
    import ser_tpu_torch.api as api
    from ser_tpu._internal.api import diagnostics as jax_diagnostics_api
    from ser_tpu_torch._internal.api import diagnostics as diagnostics_api

    env = _env(tmp_path)
    settings, jax_settings = build_settings(env), jax_build(jax_capture(env=dict(env)))
    for include in (True, False):
        ours = api.run_startup_preflight(include_transcription_checks=include, settings=settings)
        theirs = jax_api.run_startup_preflight(include_transcription_checks=include, settings=jax_settings)
        assert _shape(ours) == _shape(theirs)
        ours = diagnostics_api.run_doctor_diagnostics(settings=settings, include_transcription_checks=include)
        theirs = jax_diagnostics_api.run_doctor_diagnostics(settings=jax_settings,
                                                             include_transcription_checks=include)
        assert _shape(ours) == _shape(theirs) and ours.findings[0].code == "accelerator"
