"""Pure ``ResolvedSettingsInputs`` → ``AppConfig`` assembly.

Counterpart of ``ser_tpu/_internal/config/settings_builder.py``: catalog
defaults, then the captured environment's overrides with the same range
checks (a refused value raises ``SettingsInputError``, a ``ValueError``);
a profile request is projected over the result later
(``_internal/api/runtime.py::apply_cli_profile_override``).
"""


from __future__ import annotations

import dataclasses
import math
from pathlib import Path

from ser_tpu_torch._internal.config import schema as config_schema
from ser_tpu_torch._internal.config.settings_inputs import (
    ProfileRuntimeOverrides,
    ResolvedSettingsInputs,
    SettingsInputError,
)
from ser_tpu_torch._internal.data.ravdess import RAVDESS_EMOTIONS  # noqa: F401 - re-exported
from ser_tpu_torch.profiles import ProfileName


def _merge_runtime_overrides(
    base: config_schema.ProfileRuntimeConfig,
    overrides: ProfileRuntimeOverrides | None,
) -> config_schema.ProfileRuntimeConfig:
    if overrides is None:
        return base
    changes = {
        name: value
        for name, value in dataclasses.asdict(overrides).items()
        if value is not None
    }
    return dataclasses.replace(base, **changes) if changes else base


def build_settings_from_inputs(
    inputs: ResolvedSettingsInputs,
) -> config_schema.AppConfig:
    """Builds one immutable settings snapshot from captured inputs."""
    # The emotion map as a plain dict (the schema's default): a spawned transcription worker pickles the settings.
    base = config_schema.AppConfig()

    dataset = base.dataset
    if inputs.dataset_folder is not None:
        dataset = dataclasses.replace(dataset, folder=inputs.dataset_folder)
    if inputs.dataset_manifests:
        dataset = dataclasses.replace(dataset, manifest_paths=inputs.dataset_manifests)
    if inputs.dataset_recipe is not None:
        dataset = dataclasses.replace(dataset, recipe=inputs.dataset_recipe)
    if inputs.dataset_strict_audit is not None:
        dataset = dataclasses.replace(dataset, strict_audit=inputs.dataset_strict_audit)
    elif inputs.dataset_recipe is not None:
        # A pinned recipe implies strict auditing unless explicitly relaxed.
        dataset = dataclasses.replace(dataset, strict_audit=True)
    if inputs.dataset_registry_root is not None:
        dataset = dataclasses.replace(dataset, registry_root=inputs.dataset_registry_root)

    data_loader = base.data_loader
    loader_changes = {
        name: value
        for name, value in (
            ("max_workers", inputs.data_loader_max_workers),
            ("max_failed_files", inputs.data_loader_max_failed_files),
            ("max_failed_file_ratio", inputs.data_loader_max_failed_file_ratio),
            (
                "max_failed_file_ratio_per_corpus",
                inputs.data_loader_max_failed_file_ratio_per_corpus,
            ),
            (
                "max_failed_file_ratio_per_class",
                inputs.data_loader_max_failed_file_ratio_per_class,
            ),
            ("max_failures_per_reason", inputs.data_loader_max_failures_per_reason),
            (
                "min_remaining_per_class_split",
                inputs.data_loader_min_remaining_per_class_split,
            ),
            ("strict_quarantine", inputs.data_loader_strict_quarantine),
        )
        if value is not None
    }
    # Per-corpus/per-class budgets follow the global ratio unless independently
    # tightened.
    ratio = inputs.data_loader_max_failed_file_ratio
    if ratio is not None:
        loader_changes.setdefault("max_failed_file_ratio_per_corpus", ratio)
        loader_changes.setdefault("max_failed_file_ratio_per_class", ratio)
    if loader_changes:
        data_loader = dataclasses.replace(data_loader, **loader_changes)

    training = base.training
    training_changes = {
        name: value
        for name, value in (
            ("test_size", inputs.training_test_size),
            ("dev_size", inputs.training_dev_size),
            ("random_state", inputs.training_random_state),
        )
        if value is not None
    }
    if training_changes:
        training = dataclasses.replace(training, **training_changes)

    # SER_CACHE_DIR / SER_DATA_DIR re-home every derived folder that has no
    # specific override of its own.
    cache_root = inputs.cache_root
    data_root = inputs.data_root
    tmp_folder = inputs.tmp_folder
    if tmp_folder is None and cache_root is not None:
        tmp_folder = cache_root / "tmp"
    model_cache_dir = inputs.model_cache_dir
    if model_cache_dir is None and cache_root is not None:
        model_cache_dir = cache_root / "model-cache"
    models_folder = inputs.models_folder
    if models_folder is None and data_root is not None:
        models_folder = data_root / "models"
    transcripts_folder = inputs.transcripts_folder
    if transcripts_folder is None and data_root is not None:
        transcripts_folder = data_root / "transcripts"

    models = base.models
    model_changes: dict[str, object] = {}
    if models_folder is not None:
        model_changes["folder"] = models_folder
    if model_cache_dir is not None:
        model_changes["model_cache_dir"] = model_cache_dir
    if inputs.num_cores is not None:
        model_changes["num_cores"] = inputs.num_cores
    if inputs.model_file_name is not None:
        model_changes["model_file_name"] = inputs.model_file_name
    if inputs.secure_model_file_name is not None:
        model_changes["secure_model_file_name"] = inputs.secure_model_file_name
    if inputs.training_report_file_name is not None:
        model_changes["training_report_file_name"] = inputs.training_report_file_name
    if inputs.medium_model_id is not None:
        model_changes["medium_model_id"] = inputs.medium_model_id
    if inputs.accurate_model_id is not None:
        model_changes["accurate_model_id"] = inputs.accurate_model_id
    if inputs.accurate_research_model_id is not None:
        model_changes["accurate_research_model_id"] = inputs.accurate_research_model_id
    if inputs.whisper_model is not None:
        model_changes["whisper_model"] = dataclasses.replace(
            base.models.whisper_model, name=inputs.whisper_model
        )
    if model_changes:
        models = dataclasses.replace(models, **model_changes)

    timeline = base.timeline
    if transcripts_folder is not None:
        timeline = dataclasses.replace(timeline, folder=transcripts_folder)

    medium_training = base.medium_training
    medium_changes = {
        name: value
        for name, value in (
            ("min_window_std", inputs.medium_min_window_std),
            ("max_windows_per_clip", inputs.medium_max_windows_per_clip),
        )
        if value is not None
    }
    if medium_changes:
        medium_training = dataclasses.replace(medium_training, **medium_changes)

    quality_gate = base.quality_gate
    gate_changes = {
        name: value
        for name, value in (
            ("min_uar_delta", inputs.quality_gate_min_uar_delta),
            ("min_macro_f1_delta", inputs.quality_gate_min_macro_f1_delta),
            (
                "max_medium_segments_per_minute",
                inputs.quality_gate_max_medium_segments_per_minute,
            ),
            (
                "min_medium_median_segment_duration_seconds",
                inputs.quality_gate_min_medium_median_segment_duration_seconds,
            ),
        )
        if value is not None
    }
    if gate_changes:
        quality_gate = dataclasses.replace(quality_gate, **gate_changes)

    ontology = base.ontology
    ontology_changes: dict[str, object] = {}
    if inputs.label_ontology_id is not None:
        ontology_changes["ontology_id"] = inputs.label_ontology_id
    if inputs.allowed_labels:
        ontology_changes["allowed_labels"] = inputs.allowed_labels
    if inputs.unknown_label_policy is not None:
        ontology_changes["unknown_label_policy"] = inputs.unknown_label_policy
    if inputs.other_label is not None:
        ontology_changes["other_label"] = inputs.other_label
    if ontology_changes:
        ontology = dataclasses.replace(ontology, **ontology_changes)

    schema_config = base.schema
    schema_changes = {
        name: value
        for name, value in (
            ("output_schema_version", inputs.output_schema_version),
            ("artifact_schema_version", inputs.artifact_schema_version),
        )
        if value is not None
    }
    if schema_changes:
        schema_config = dataclasses.replace(schema_config, **schema_changes)

    transcription = base.transcription
    tx_changes: dict[str, object] = {}
    if inputs.whisper_backend is not None:
        tx_changes["backend_id"] = inputs.whisper_backend
    if inputs.whisper_demucs is not None:
        tx_changes["use_demucs"] = inputs.whisper_demucs
    if inputs.whisper_vad is not None:
        tx_changes["use_vad"] = inputs.whisper_vad
    if inputs.separation_model_path is not None:
        tx_changes["separation_model_path"] = Path(inputs.separation_model_path)
    if inputs.whisper_decode_strategy is not None:
        if inputs.whisper_decode_strategy not in ("greedy", "beam"):
            raise SettingsInputError(
                "WHISPER_DECODE_STRATEGY must be 'greedy' or 'beam', got "
                f"{inputs.whisper_decode_strategy!r}."
            )
        tx_changes["decode_strategy"] = inputs.whisper_decode_strategy
    if inputs.whisper_beam_size is not None:
        if not 1 <= inputs.whisper_beam_size <= 16:
            raise SettingsInputError("WHISPER_BEAM_SIZE must be in [1, 16].")
        tx_changes["beam_size"] = inputs.whisper_beam_size
    if inputs.whisper_length_penalty is not None:
        penalty = inputs.whisper_length_penalty
        # Negative penalties invert length normalization (the shortest
        # hypothesis would always win) and non-finite values poison every
        # beam score — reject rather than silently degrade transcripts.
        if not math.isfinite(penalty) or not 0.0 <= penalty <= 5.0:
            raise SettingsInputError("WHISPER_LENGTH_PENALTY must be finite and in [0, 5].")
        tx_changes["length_penalty"] = penalty
    if inputs.hbm_admission_control is not None:
        tx_changes["hbm_admission_control_enabled"] = inputs.hbm_admission_control
    if inputs.hbm_hard_oom_shortcut is not None:
        tx_changes["hbm_hard_oom_shortcut_enabled"] = inputs.hbm_hard_oom_shortcut
    if inputs.hbm_admission_min_headroom_mb is not None:
        if inputs.hbm_admission_min_headroom_mb < 0:
            raise SettingsInputError("HBM admission min headroom must be >= 0 MB.")
        tx_changes["hbm_admission_min_headroom_mb"] = inputs.hbm_admission_min_headroom_mb
    if inputs.hbm_admission_safety_margin_mb is not None:
        if inputs.hbm_admission_safety_margin_mb < 0:
            raise SettingsInputError("HBM admission safety margin must be >= 0 MB.")
        tx_changes["hbm_admission_safety_margin_mb"] = inputs.hbm_admission_safety_margin_mb
    if inputs.calibration_overrides is not None:
        tx_changes["calibration_overrides_enabled"] = inputs.calibration_overrides
    if inputs.calibration_min_confidence is not None:
        confidence = inputs.calibration_min_confidence.strip().lower()
        if confidence not in ("low", "medium", "high"):
            raise SettingsInputError(
                "Calibration min confidence must be low, medium, or high, got "
                f"{inputs.calibration_min_confidence!r}."
            )
        tx_changes["calibration_min_confidence"] = confidence
    if inputs.calibration_report_max_age_hours is not None:
        if inputs.calibration_report_max_age_hours <= 0:
            raise SettingsInputError("Calibration report max age must be > 0 hours.")
        tx_changes["calibration_report_max_age_hours"] = (
            inputs.calibration_report_max_age_hours
        )
    if inputs.calibration_report_path is not None:
        tx_changes["calibration_report_path"] = Path(inputs.calibration_report_path)
    if tx_changes:
        transcription = dataclasses.replace(transcription, **tx_changes)

    runtime_flags = dataclasses.replace(
        base.runtime_flags,
        profile_pipeline=bool(inputs.enable_profile_pipeline),
        medium_profile=bool(inputs.enable_medium_profile),
        accurate_profile=bool(inputs.enable_accurate_profile),
        accurate_research_profile=bool(inputs.enable_accurate_research_profile),
        restricted_backends=bool(inputs.enable_restricted_backends),
        allowed_restricted_backends=tuple(inputs.allowed_restricted_backends),
        new_output_schema=bool(inputs.new_output_schema),
    )

    torch_runtime = base.torch_runtime
    if inputs.device is not None or inputs.dtype is not None:
        torch_runtime = dataclasses.replace(
            torch_runtime,
            device=inputs.device if inputs.device is not None else torch_runtime.device,
            dtype=inputs.dtype if inputs.dtype is not None else torch_runtime.dtype,
        )

    mesh = base.mesh
    if inputs.mesh_data_axis_size is not None or inputs.mesh_model_axis_size is not None:
        mesh = dataclasses.replace(
            mesh,
            data_axis_size=(
                inputs.mesh_data_axis_size
                if inputs.mesh_data_axis_size is not None
                else mesh.data_axis_size
            ),
            model_axis_size=(
                inputs.mesh_model_axis_size
                if inputs.mesh_model_axis_size is not None
                else mesh.model_axis_size
            ),
        )

    overrides = inputs.profile_runtime_overrides

    def runtime_for(profile: ProfileName, base_config):
        return _merge_runtime_overrides(base_config, overrides.get(profile))

    return dataclasses.replace(
        base,
        tmp_folder=tmp_folder if tmp_folder is not None else base.tmp_folder,
        dataset=dataset,
        data_loader=data_loader,
        training=training,
        models=models,
        timeline=timeline,
        transcription=transcription,
        runtime_flags=runtime_flags,
        medium_training=medium_training,
        quality_gate=quality_gate,
        ontology=ontology,
        schema=schema_config,
        torch_runtime=torch_runtime,
        mesh=mesh,
        fast_runtime=runtime_for("fast", base.fast_runtime),
        medium_runtime=runtime_for("medium", base.medium_runtime),
        accurate_runtime=runtime_for("accurate", base.accurate_runtime),
        accurate_research_runtime=runtime_for(
            "accurate-research", base.accurate_research_runtime
        ),
        default_language=(
            inputs.default_language
            if inputs.default_language is not None
            else base.default_language
        ),
    )


__all__ = ["RAVDESS_EMOTIONS", "build_settings_from_inputs"]
