"""The slice as a whole: accurate-profile ``infer`` of the port against ``ser_tpu``.

One environment configures both packages: a tiny HF Whisper checkpoint under
the HF cache root (both load the same weights through their normal loaders),
one head artifact written by ``ser_tpu``, and ``SER_TORCH_DEVICE=cpu``. A 45 s
clip (two windows, the second partial) through ``ser_tpu.api.infer`` and
``ser_tpu_torch.api.infer`` gives identical labels and segment boundaries, the
same ``backend_id``, and frame probabilities within 1e-5 (transcript off;
``tests/test_torch_transcription.py`` holds the transcript lane). Without a CPU
request the port raises on this GPU-less host instead of running on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

import ser_tpu.api as jax_api
import ser_tpu_torch.api as torch_api
from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.models.mlp_head import JaxMLPClassifier
import ser_tpu.profiles as jax_profiles
from ser_tpu_torch import profiles
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.runtime.errors import (
    ModelUnavailableError,
    RuntimeDependencyError,
    UnsupportedProfileError,
)

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

MODEL_ID = "openai/whisper-large-v3"
D_MODEL = 64
LABELS = ["angry", "happy", "neutral", "sad"]
#: Frame probabilities of the int8 encode against the float32 one: 5.6e-4 at most on the CPU.
INT8_PROBABILITY_TOLERANCE = 5e-3


def _write_hf_checkpoint(model_dir) -> None:
    cfg = transformers.WhisperConfig(
        vocab_size=320,
        num_mel_bins=80,
        d_model=D_MODEL,
        encoder_layers=2,
        encoder_attention_heads=4,
        decoder_layers=1,
        decoder_attention_heads=4,
        encoder_ffn_dim=4 * D_MODEL,
        decoder_ffn_dim=4 * D_MODEL,
        max_source_positions=1500,
        max_target_positions=64,
        activation_function="gelu",
        decoder_start_token_id=1,
        bos_token_id=1,
        eos_token_id=2,
        pad_token_id=0,
    )
    torch.manual_seed(0)
    transformers.WhisperModel(cfg).eval().save_pretrained(model_dir, safe_serialization=True)


def _write_head_artifact(path) -> None:
    rng = np.random.default_rng(0)
    dims = [2 * D_MODEL, 32, len(LABELS)]
    state = {
        "kind": "ser_tpu_mlp",
        "hidden_layer_sizes": [32],
        "alpha": 0.01,
        "batch_size": 256,
        "epsilon": 1e-8,
        "max_iter": 500,
        "random_state": 42,
        "classes": LABELS,
        "weights": [
            (rng.standard_normal((a, b)) * 2.0 * np.sqrt(2.0 / (a + b))).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])
        ],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]],
        "n_iter": 1,
        "loss": 1.0,
    }
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=2 * D_MODEL,
        training_samples=8,
        labels=LABELS,
        backend_id="jax_whisper_encoder",
        profile="accurate",
        pooling_strategy="mean_std",
        backend_model_id=MODEL_ID,
    )
    envelope = jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata)
    jax_artifacts.save_model_artifact(envelope, path)


def _write_clip(path, seconds: float = 45.0, sample_rate: int = 22050) -> None:
    """Tones and noise whose mix changes every few seconds."""
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    audio = mix * np.sin(2 * np.pi * 220 * t) + (1 - mix) * 0.5 * rng.standard_normal(t.size)
    write_wav(path, (0.8 * audio / np.abs(audio).max()).astype(np.float32), sample_rate)


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("accurate")
    cache, models = root / "cache", root / "models"
    _write_hf_checkpoint(cache / "model-cache" / "huggingface" / MODEL_ID)
    artifact_name = profile_artifact_file_names(profile="accurate", accurate_model_id=MODEL_ID)[0]
    _write_head_artifact(models / artifact_name)
    clip = root / "clip.wav"
    _write_clip(clip)
    env = {
        "SER_ENABLE_ACCURATE_PROFILE": "1",
        "SER_MODELS_FOLDER": str(models),
        "SER_CACHE_DIR": str(cache),
        "SER_TORCH_DEVICE": "cpu",
    }
    return {"env": env, "clip": clip}


@pytest.fixture(scope="module")
def executions(staged) -> tuple:
    env = staged["env"]
    jax_settings = build_settings_from_inputs(capture_settings_inputs(env))
    reference = jax_api.infer(
        staged["clip"], profile="accurate", include_transcript=False, settings=jax_settings
    )
    ported = torch_api.infer(
        staged["clip"], profile="accurate", include_transcript=False, settings=build_settings(env)
    )
    return reference, ported


def test_same_labels_and_segment_boundaries(executions) -> None:
    reference, ported = executions
    assert ported.backend_id == reference.backend_id == "jax_whisper_encoder"
    assert ported.profile == reference.profile == "accurate"
    assert ported.output_schema_version == reference.output_schema_version
    assert [tuple(s) for s in ported.emotions] == [tuple(s) for s in reference.emotions]
    assert len(ported.emotions) >= 1
    assert [tuple(e) for e in ported.timeline] == [tuple(e) for e in reference.timeline]
    assert ported.transcript == reference.transcript == []


def test_frames_match_within_tolerance(executions) -> None:
    reference, ported = executions
    ref_frames = reference.detailed_result.frames
    our_frames = ported.detailed_result.frames
    assert len(our_frames) == len(ref_frames) == 45
    for ours, ref in zip(our_frames, ref_frames):
        assert (ours.start_seconds, ours.end_seconds, ours.emotion) == (
            ref.start_seconds,
            ref.end_seconds,
            ref.emotion,
        )
        assert ours.probabilities.keys() == ref.probabilities.keys()
        for label, probability in ref.probabilities.items():
            assert abs(ours.probabilities[label] - probability) <= 1e-5
    distinct = {frame.emotion for frame in our_frames}
    assert len(distinct) >= 2, "the clip should exercise more than one label"


def test_phase_timings_are_recorded(executions) -> None:
    _, ported = executions
    assert {"workflow_total", "emotion_setup", "emotion_inference"} <= set(ported.phase_timings_seconds)


def test_auto_device_raises_without_a_card(staged) -> None:
    env = {key: value for key, value in staged["env"].items() if key != "SER_TORCH_DEVICE"}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        torch_api.infer(staged["clip"], profile="accurate", settings=build_settings(env))


@pytest.mark.parametrize(
    "options",
    [
        {"subtitle_format": "srt"},
        {"save_transcript": True},
        {"subtitle_output_path": "out.srt"},
        {"profile": "fast", "subtitle_format": "vtt"},
        {"profile": "accurate-research", "save_transcript": True},
    ],
)
def test_unported_options_raise(staged, options, tmp_path) -> None:
    """CSV and subtitle export, once refused in every profile, now write their files as ``ser_tpu``
    does (``tests/test_torch_transcript_export.py`` holds their bytes to it). The fast profile (no
    head staged here) and the accurate-research profile (gate shut) now fail on their own grounds,
    and write nothing."""
    kwargs = {"profile": "accurate", **options}
    if "subtitle_output_path" in kwargs:
        kwargs["subtitle_output_path"] = str(tmp_path / kwargs["subtitle_output_path"])
    settings = build_settings({**staged["env"], "SER_TRANSCRIPTS_FOLDER": str(tmp_path / "transcripts")})
    if kwargs["profile"] == "accurate-research":
        with pytest.raises(UnsupportedProfileError, match="restricted backend"):
            torch_api.infer(staged["clip"], settings=settings, include_transcript=False, **kwargs)
        assert not (tmp_path / "transcripts").exists()
        return
    if kwargs["profile"] == "fast":
        with pytest.raises(ModelUnavailableError, match="Train it first"):
            torch_api.infer(staged["clip"], settings=settings, include_transcript=False, **kwargs)
        assert not (tmp_path / "transcripts").exists()
        return
    execution = torch_api.infer(staged["clip"], settings=settings, include_transcript=False, **kwargs)
    written = execution.timeline_csv_path if options.get("save_transcript") else execution.subtitle_path
    expected = {
        "subtitle_format": tmp_path / "transcripts" / "clip.srt",
        "save_transcript": tmp_path / "transcripts" / "clip.csv",
        "subtitle_output_path": tmp_path / "out.srt",
    }[next(iter(options))]
    assert written == str(expected) and expected.is_file()
    if options.get("save_transcript"):
        assert expected.read_text(encoding="utf-8").splitlines()[0] == "Time (s),Emotion,Speech"


def test_int8_dtype_is_not_ported(staged, executions) -> None:
    """``SER_TORCH_DTYPE=int8`` now runs: the encoder's projections W8A8 (float32
    around them on the CPU), the same frames as the float32 run, each frame's
    probabilities within int8's noise of it."""
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch.models.quant import QuantDense

    env = {**staged["env"], "SER_TORCH_DTYPE": "int8"}
    settings = build_settings(env)
    quantized = torch_api.infer(staged["clip"], profile="accurate", include_transcript=False, settings=settings)
    backend = encoders.build_encoder_backend("accurate", settings)
    assert any(isinstance(module, QuantDense) for module in backend._encoder.modules())
    _, full = executions
    assert quantized.backend_id == full.backend_id == "jax_whisper_encoder"
    assert len(quantized.detailed_result.frames) == len(full.detailed_result.frames) == 45
    worst = max(
        abs(ours.probabilities[label] - ref.probabilities[label])
        for ours, ref in zip(quantized.detailed_result.frames, full.detailed_result.frames)
        for label in ref.probabilities
    )
    assert 0.0 < worst <= INT8_PROBABILITY_TOLERANCE


def test_accurate_catalog_entry_matches_ser_tpu() -> None:
    ours = profiles.require_ported("accurate")
    reference = jax_profiles.get_profile_catalog()["accurate"]
    assert ours.backend_id == reference.backend_id == "jax_whisper_encoder"
    assert ours.default_model_id == reference.model.default_model_id
    assert vars(ours.runtime_defaults) == vars(reference.runtime_defaults)


def test_runtime_knobs_read_the_same_variables_as_ser_tpu() -> None:
    env = {
        "SER_ACCURATE_POOL_WINDOW_SIZE_SECONDS": "2.0",
        "SER_ACCURATE_POOL_WINDOW_STRIDE_SECONDS": "0.5",
        "SER_ACCURATE_POST_SMOOTHING_WINDOW_FRAMES": "5",
        "SER_ACCURATE_POST_HYSTERESIS_ENTER_CONFIDENCE": "0.7",
        "SER_ACCURATE_POST_HYSTERESIS_EXIT_CONFIDENCE": "0.4",
        "SER_ACCURATE_POST_MIN_SEGMENT_DURATION_SECONDS": "1.5",
        "SER_OUTPUT_SCHEMA_VERSION": "v1",
    }
    ours = build_settings(env)
    reference = build_settings_from_inputs(capture_settings_inputs(env))
    for knob in (
        "pool_window_size_seconds",
        "pool_window_stride_seconds",
        "post_smoothing_window_frames",
        "post_hysteresis_enter_confidence",
        "post_hysteresis_exit_confidence",
        "post_min_segment_duration_seconds",
    ):
        assert getattr(ours.accurate_runtime, knob) == getattr(reference.accurate_runtime, knob), knob
    assert ours.schema.output_schema_version == reference.schema.output_schema_version
