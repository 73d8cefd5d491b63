"""The port's settings layer against ``ser_tpu``'s, on the CPU.

The same environment dict goes through both packages'
``capture_settings_inputs → build_settings_from_inputs`` (the port's
``bootstrap.build_settings``). Held exactly: every field the two ``AppConfig``s
share, as nested dicts (the port's ``TorchRuntimeConfig`` has no MPS fallback
and reads ``SER_TORCH_*`` only, so ``torch_runtime.enable_mps_fallback`` is
the one field left out); the field each variable sets, one variable at a time
(the variables the port read none of before its whole settings layer: HBM
admission, calibration, the quality gate, the artifact names, the schema
versions, the core count, ``DEFAULT_LANGUAGE``); ``get_settings``,
``reload_settings`` and ``settings_override`` scoping; the refusals of bad
values, by exception class.
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import pytest

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs as jax_build
from ser_tpu._internal.config.settings_inputs import SettingsInputError as JaxSettingsInputError
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs as jax_capture
from ser_tpu_torch._internal.config import bootstrap
from ser_tpu_torch._internal.config.bootstrap import SettingsInputError

#: Fields of the JAX package's schema the port does not carry (the MPS fallback of its accelerator selector).
_JAX_ONLY_FIELDS = {"torch_runtime.enable_mps_fallback"}


def _jax_settings(env: dict[str, str]):
    return jax_build(jax_capture(env=dict(env)))


def _flat(config, prefix: str = "") -> dict[str, object]:
    out: dict[str, object] = {}
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        if dataclasses.is_dataclass(value):
            out.update(_flat(value, f"{prefix}{field.name}."))
        else:
            out[f"{prefix}{field.name}"] = dict(value) if field.name == "emotions" else value
    return out


def _field(config, dotted: str):
    for name in dotted.split("."):
        config = getattr(config, name)
    return config


#: (variable, value, the ``AppConfig`` field it sets). The HBM and calibration knobs are read under their
#: ``_HBM_`` names and their ``_MPS_`` aliases.
_HBM = [
    ("ADMISSION_CONTROL", "0", "transcription.hbm_admission_control_enabled"),
    ("MIN_HEADROOM_MB", "512.5", "transcription.hbm_admission_min_headroom_mb"),
    ("SAFETY_MARGIN_MB", "64", "transcription.hbm_admission_safety_margin_mb"),
    ("CALIBRATION_OVERRIDES", "false", "transcription.calibration_overrides_enabled"),
    ("CALIBRATION_MIN_CONFIDENCE", "Medium", "transcription.calibration_min_confidence"),
    ("CALIBRATION_REPORT_MAX_AGE_HOURS", "12", "transcription.calibration_report_max_age_hours"),
    ("CALIBRATION_REPORT_PATH", "/calib/report.json", "transcription.calibration_report_path"),
]
VARIABLES = (
    [(f"SER_TRANSCRIPTION_HBM_{name}", value, path) for name, value, path in _HBM]
    + [(f"SER_TRANSCRIPTION_MPS_{name}", value, path) for name, value, path in _HBM]
    + [
        ("SER_QUALITY_GATE_MIN_UAR_DELTA", "0.01", "quality_gate.min_uar_delta"),
        ("SER_QUALITY_GATE_MIN_MACRO_F1_DELTA", "0.02", "quality_gate.min_macro_f1_delta"),
        ("SER_QUALITY_GATE_MAX_MEDIUM_SEGMENTS_PER_MINUTE", "18.5", "quality_gate.max_medium_segments_per_minute"),
        (
            "SER_QUALITY_GATE_MIN_MEDIUM_MEDIAN_SEGMENT_DURATION_SECONDS",
            "1.75",
            "quality_gate.min_medium_median_segment_duration_seconds",
        ),
        ("SER_SECURE_MODEL_FILE_NAME", "custom.skops", "models.secure_model_file_name"),
        ("SER_TRAINING_REPORT_FILE_NAME", "custom_report.json", "models.training_report_file_name"),
        ("SER_ARTIFACT_SCHEMA_VERSION", "v9", "schema.artifact_schema_version"),
        ("SER_NEW_OUTPUT_SCHEMA", "1", "runtime_flags.new_output_schema"),
        ("SER_ENABLE_NEW_OUTPUT_SCHEMA", "yes", "runtime_flags.new_output_schema"),
        ("SER_NUM_CORES", "6", "models.num_cores"),
        ("DEFAULT_LANGUAGE", "fr", "default_language"),
    ]
)


@pytest.mark.parametrize(("variable", "value", "path"), VARIABLES, ids=[v[0] for v in VARIABLES])
def test_each_variable_sets_the_same_field(variable: str, value: str, path: str) -> None:
    ours = _field(bootstrap.build_settings({variable: value}), path)
    theirs = _field(_jax_settings({variable: value}), path)
    assert ours == theirs
    assert ours != _field(bootstrap.build_settings({}), path)


REFERENCE_CANONICAL_ENV = {
    "DATASET_FOLDER": "/data/speech/corpus",
    "DEFAULT_LANGUAGE": "de",
    "SER_STRICT_DATASET_AUDIT": "1",
    "SER_MAX_WORKERS": "3",
    "SER_MAX_FAILED_FILES": "7",
    "SER_MAX_FAILED_FILE_RATIO": "0.125",
    "SER_MAX_FAILURES_PER_REASON": "4",
    "SER_MIN_REMAINING_PER_CLASS_SPLIT": "2",
    "SER_STRICT_QUARANTINE": "true",
    "SER_TEST_SIZE": "0.3",
    "SER_DEV_SIZE": "0.15",
    "SER_RANDOM_STATE": "1234",
    "SER_ENABLE_PROFILE_PIPELINE": "1",
    "SER_ENABLE_MEDIUM_PROFILE": "1",
    "SER_ENABLE_ACCURATE_PROFILE": "1",
    "SER_ENABLE_NEW_OUTPUT_SCHEMA": "1",
    "SER_MODEL_FILE_NAME": "custom_model.pkl",
    "SER_SECURE_MODEL_FILE_NAME": "custom_model.skops",
    "SER_TRAINING_REPORT_FILE_NAME": "custom_report.json",
    "SER_OUTPUT_SCHEMA_VERSION": "v2",
    "SER_MEDIUM_MIN_WINDOW_STD": "0.25",
    "SER_MEDIUM_MAX_WINDOWS_PER_CLIP": "12",
    "SER_QUALITY_GATE_MIN_UAR_DELTA": "0.01",
    "SER_QUALITY_GATE_MIN_MACRO_F1_DELTA": "0.02",
    "SER_QUALITY_GATE_MAX_MEDIUM_SEGMENTS_PER_MINUTE": "18.5",
    "SER_QUALITY_GATE_MIN_MEDIUM_MEDIAN_SEGMENT_DURATION_SECONDS": "1.75",
    "WHISPER_DEMUCS": "1",
    "WHISPER_VAD": "0",
    "SER_FAST_TIMEOUT_SECONDS": "42.5",
    "SER_MEDIUM_POOL_WINDOW_SIZE_SECONDS": "3.5",
}

#: The environments of ``tests/suites/parity/test_parity_settings.py``, and the rest of the variables both read.
ENVIRONMENTS = {
    "defaults": {},
    "reference-canonical": REFERENCE_CANONICAL_ENV,
    "global-ratio": {"SER_MAX_FAILED_FILE_RATIO": "0.2"},
    "pinned-class-ratio": {"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_MAX_FAILED_FILE_RATIO_PER_CLASS": "0.05"},
    "recipe": {"SER_DATASET_RECIPE": "research-v1"},
    "recipe-relaxed": {"SER_DATASET_RECIPE": "research-v1", "SER_STRICT_DATASET_AUDIT": "0"},
    "roots": {"SER_CACHE_DIR": "/fast/cache", "SER_DATA_DIR": "/fast/data"},
    "roots-models-alias": {"SER_CACHE_DIR": "/fast/cache", "SER_DATA_DIR": "/fast/data",
                           "SER_MODELS_DIR": "/elsewhere/models"},
    "manifests": {"SER_DATASET_MANIFESTS": "/a/one.jsonl, /b/two.jsonl"},
    "tmp-alias": {"SER_TMP_DIR": "/scratch/tmp"},
    "transcripts-alias": {"SER_TRANSCRIPTS_DIR": "/out/transcripts"},
    "models-alias": {"SER_MODELS_DIR": "/out/models"},
    "transcription": {
        "WHISPER_BACKEND": "jax_whisper", "WHISPER_MODEL": "turbo", "WHISPER_DECODE_STRATEGY": "beam",
        "WHISPER_BEAM_SIZE": "4", "WHISPER_LENGTH_PENALTY": "0.5", "SER_SEPARATION_MODEL_PATH": "/sep/u.npz",
        "SER_TRANSCRIPTION_MPS_ADMISSION_CONTROL": "0", "SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT": "0",
        "SER_TRANSCRIPTION_HBM_MIN_HEADROOM_MB": "1024", "SER_TRANSCRIPTION_MPS_CALIBRATION_MIN_CONFIDENCE": "low",
    },
    "profiles-and-gate": {
        "SER_ENABLE_ACCURATE_RESEARCH_PROFILE": "1", "SER_ENABLE_RESTRICTED_BACKENDS": "on",
        "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec, other", "SER_MEDIUM_MODEL_ID": "org/m",
        "SER_ACCURATE_MODEL_ID": "org/a", "SER_ACCURATE_RESEARCH_MODEL_ID": "org/r",
        "SER_ACCURATE_RESEARCH_PROCESS_ISOLATION": "1", "SER_ACCURATE_MAX_TRANSIENT_RETRIES": "3",
        "SER_MEDIUM_POST_SMOOTHING_WINDOW_FRAMES": "5",
    },
    "ontology-and-device": {
        "SER_LABEL_ONTOLOGY_ID": "custom_v2", "SER_ALLOWED_LABELS": "happy, sad", "SER_UNKNOWN_LABEL_POLICY": "bogus",
        "SER_OTHER_LABEL": "misc", "SER_TORCH_DEVICE": "cpu", "SER_TORCH_DTYPE": "float32",
        "SER_MESH_DATA_AXIS_SIZE": "2", "SER_MESH_MODEL_AXIS_SIZE": "2", "SER_DATASET_REGISTRY_ROOT": "/reg",
    },
}


@pytest.mark.parametrize("name", list(ENVIRONMENTS))
def test_app_config_dicts_agree(name: str) -> None:
    env = ENVIRONMENTS[name]
    ours = _flat(bootstrap.build_settings(env))
    theirs = {key: value for key, value in _flat(_jax_settings(env)).items() if key not in _JAX_ONLY_FIELDS}
    assert ours == theirs


def test_port_reads_its_own_selectors_only() -> None:
    """``SER_JAX_*`` selects the JAX package's device; the port's are ``SER_TORCH_*``."""
    settings = bootstrap.build_settings({"SER_JAX_DEVICE": "tpu", "SER_JAX_DTYPE": "bfloat16"})
    assert (settings.torch_runtime.device, settings.torch_runtime.dtype) == ("auto", "auto")
    settings = bootstrap.build_settings({"SER_TORCH_DEVICE": "cpu", "SER_TORCH_DTYPE": "bfloat16"})
    assert (settings.torch_runtime.device, settings.torch_runtime.dtype) == ("cpu", "bfloat16")


BAD_VALUES = [
    {"SER_ENABLE_MEDIUM_PROFILE": "maybe"},
    {"SER_TEST_SIZE": "a quarter"},
    {"SER_RANDOM_STATE": "4.5"},
    {"SER_TRANSCRIPTION_HBM_ADMISSION_CONTROL": "sometimes"},
    {"SER_TRANSCRIPTION_HBM_MIN_HEADROOM_MB": "-1"},
    {"SER_TRANSCRIPTION_MPS_SAFETY_MARGIN_MB": "-0.5"},
    {"SER_TRANSCRIPTION_HBM_CALIBRATION_MIN_CONFIDENCE": "certain"},
    {"SER_TRANSCRIPTION_HBM_CALIBRATION_REPORT_MAX_AGE_HOURS": "0"},
    {"SER_QUALITY_GATE_MIN_UAR_DELTA": "high"},
    {"SER_NUM_CORES": "many"},
    {"WHISPER_DECODE_STRATEGY": "sample"},
    {"WHISPER_BEAM_SIZE": "17"},
    {"WHISPER_LENGTH_PENALTY": "nan"},
    {"SER_FAST_TIMEOUT_SECONDS": "soon"},
]


@pytest.mark.parametrize("env", BAD_VALUES, ids=[next(iter(env)) + "=" + next(iter(env.values())) for env in BAD_VALUES])
def test_bad_values_refused_alike(env: dict[str, str]) -> None:
    with pytest.raises(ValueError) as theirs:
        _jax_settings(env)
    with pytest.raises(ValueError) as ours:
        bootstrap.build_settings(env)
    # A reader's refusal is SettingsInputError in both; the builder's range checks raise the port's
    # SettingsInputError (a ValueError) where the JAX package raises ValueError itself.
    assert isinstance(ours.value, SettingsInputError)
    assert isinstance(theirs.value, JaxSettingsInputError) == (type(theirs.value) is not ValueError)
    assert str(ours.value) == str(theirs.value)


def test_get_reload_and_override_scoping(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setenv("SER_DEFAULT_LANGUAGE", "it")
    ambient = bootstrap.reload_settings()
    assert ambient.default_language == "it" and bootstrap.get_settings() is ambient
    monkeypatch.setenv("SER_DEFAULT_LANGUAGE", "pt")
    assert bootstrap.get_settings() is ambient  # captured once per (re)load
    modified = dataclasses.replace(ambient, default_language="de")
    with bootstrap.settings_override(modified) as scoped:
        assert scoped is modified and bootstrap.get_settings() is modified
        with bootstrap.settings_override(dataclasses.replace(ambient, default_language="es")):
            assert bootstrap.get_settings().default_language == "es"
        assert bootstrap.get_settings().default_language == "de"
        seen: list[str] = []
        worker = threading.Thread(target=lambda: seen.append(bootstrap.get_settings().default_language))
        worker.start()
        worker.join()
        assert seen == ["it"]  # another thread's context does not see this scope
    assert bootstrap.get_settings() is ambient
    assert bootstrap.reload_settings().default_language == "pt"
    monkeypatch.delenv("SER_DEFAULT_LANGUAGE")
    bootstrap.reload_settings()


def test_public_config_facade_matches() -> None:
    import inspect

    import ser_tpu.config as jax_config
    import ser_tpu_torch.config as torch_config

    assert sorted(torch_config.__all__) == sorted(jax_config.__all__)
    for name in ("get_settings", "reload_settings", "settings_override", "profile_artifact_file_names"):
        assert inspect.signature(getattr(torch_config, name)) == inspect.signature(getattr(jax_config, name))
    for profile in ("fast", "medium", "accurate", "accurate-research"):
        assert torch_config.profile_artifact_file_names(profile=profile) == jax_config.profile_artifact_file_names(
            profile=profile
        )
        assert torch_config.profile_artifact_file_names(
            profile=profile, medium_model_id="o/m", accurate_model_id="o/a", accurate_research_model_id="o/r"
        ) == jax_config.profile_artifact_file_names(
            profile=profile, medium_model_id="o/m", accurate_model_id="o/a", accurate_research_model_id="o/r"
        )
    with pytest.raises(RuntimeError):
        torch_config.default_profile_model_id("fast")
    assert torch_config.default_profile_model_id("accurate") == jax_config.default_profile_model_id("accurate")
    theirs = _flat(jax_config.AppConfig(emotions={"01": "neutral"}))
    ours = _flat(torch_config.AppConfig(emotions={"01": "neutral"}))
    assert ours == {key: value for key, value in theirs.items() if key not in _JAX_ONLY_FIELDS}
    assert isinstance(ours["transcription.calibration_report_path"], type(None))
    assert torch_config.AppConfig().models.training_report_file == Path(
        ours["models.folder"]
    ) / "training_report.json"
