"""``ser_tpu_torch.api.train`` against ``ser_tpu.api.train``, on the CPU (``SER_TORCH_DEVICE=cpu``).

- Dispatch: each of the four profiles reaches its own training entry point
  (the encoder profiles ``train_encoder_profile_model`` with their profile,
  fast ``train_fast_model``), as in ``ser_tpu``; ``emotion_model.train_model``
  trains the fast head.
- The license gate: accurate-research training without consent stops in
  readiness in both packages (``restricted_backend_access``).
- Round trips on ``scripts/build_synthetic_ravdess_dataset.py``'s corpus:
  ``api.train(profile="fast")`` then ``api.infer(profile="fast")`` on a
  held-out clip, in each package; the artifact each writes is served by the
  other's ``api.infer``, with the same labels; the accurate profile on a tiny
  HF Whisper checkpoint trained and served by the port.
- No stale head: after a second ``api.train`` rewrites the artifact, the same
  process's ``api.infer`` serves the new head, as a cold process would (the
  encoder backends cached for both are emptied for the comparison).
- Without a CPU request the port's ``api.train`` raises on this card-less host
  before it reads the corpus.
- The fast training report keeps ``ser_tpu``'s keys and counts, and
  ``build_provenance_metadata`` gives ``ser_tpu``'s license and access facts
  (all but the dependency fingerprint, which names each package's own
  compute libraries) for each state of the gate.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ser_tpu.api as jax_api
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import encoder_training as jax_encoder_training
from ser_tpu._internal.models import fast_training as jax_fast_training
from ser_tpu._internal.models.training_orchestration import TrainingNotReadyError as JaxTrainingNotReadyError
from ser_tpu._internal.runtime import restricted_backends as jax_rb
from ser_tpu._internal.utils.audio_io import write_wav
import ser_tpu_torch.api as api
from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_names
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.models import artifacts, emotion_model, encoder_training, fast_training
from ser_tpu_torch._internal.models.training_orchestration import TrainingNotReadyError
from ser_tpu_torch._internal.repr import encoders
from ser_tpu_torch._internal.runtime import restricted_backends as rb
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from build_synthetic_ravdess_dataset import build_dataset, synthesize_clip  # noqa: E402

PROFILES = ("fast", "medium", "accurate", "accurate-research")
WHISPER_ID = "openai/whisper-large-v3"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on a few cores: one intra-op thread each keeps the CPU's many small
    feature and encoder ops from contending for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("api_train")
    build_dataset(root / "ds", actors=2, repetitions=2, seconds=1.2)
    write_wav(root / "held_out.wav", synthesize_clip("05", 4242, 16000, 3.2), 16000)
    return root


def _env(root: Path, tag: str, **extra: str) -> dict[str, str]:
    return {
        "SER_DATASET_FOLDER": str(root / "ds"),
        "SER_MODELS_FOLDER": str(root / tag / "models"),
        "SER_TMP_FOLDER": str(root / tag / "tmp"),
        "SER_CACHE_DIR": str(root / "cache"),
        "SER_TORCH_DEVICE": "cpu",
        **extra,
    }


def _jax_settings(env: dict[str, str]):
    return build_settings_from_inputs(capture_settings_inputs(env=env))


def _small_head(settings, **changes):
    return dataclasses.replace(settings, nn=dataclasses.replace(settings.nn, **{"max_iter": 200, **changes}))


@pytest.mark.parametrize("profile", PROFILES)
def test_train_dispatches_to_the_profile_entry_point_as_ser_tpu_does(profile, corpus, monkeypatch) -> None:
    calls: list[tuple[str, str]] = []

    def recorder(package: str):
        def encoder(*, profile, settings, backend=None):
            calls.append((package, profile))
            return {}

        def fast(*, settings):
            calls.append((package, "fast"))
            return {}

        return encoder, fast

    for package, module_pair in (("torch", (encoder_training, fast_training)),
                                 ("jax", (jax_encoder_training, jax_fast_training))):
        encoder, fast = recorder(package)
        monkeypatch.setattr(module_pair[0], "train_encoder_profile_model", encoder)
        monkeypatch.setattr(module_pair[1], "train_fast_model", fast)
    env = _env(corpus, "dispatch")
    api.train(profile=profile, settings=build_settings(env))
    jax_api.train(profile=profile, settings=_jax_settings(env))
    assert calls == [("torch", profile), ("jax", profile)]


def test_accurate_research_training_stops_at_the_license_gate_in_both(corpus) -> None:
    env = _env(corpus, "gate", SER_MAX_FAILED_FILE_RATIO="0.2")
    with pytest.raises(TrainingNotReadyError, match="restricted") as ours:
        api.train(profile="accurate-research", settings=build_settings(env))
    with pytest.raises(JaxTrainingNotReadyError, match="restricted") as theirs:
        jax_api.train(profile="accurate-research", settings=_jax_settings(env))
    assert str(ours.value).split(":")[0] == str(theirs.value).split(":")[0]


def test_train_without_a_cpu_request_raises_on_a_host_without_a_card(corpus) -> None:
    env = _env(corpus, "no-card")
    del env["SER_TORCH_DEVICE"]
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        api.train(profile="fast", settings=build_settings(env))
    assert not (corpus / "no-card").exists()


@pytest.fixture(scope="module")
def fast_round_trip(corpus) -> dict:
    ours_env, theirs_env = _env(corpus, "fast-ours"), _env(corpus, "fast-theirs")
    ours_settings = _small_head(build_settings(ours_env))
    theirs_settings = _small_head(_jax_settings(theirs_env))
    report = emotion_model.train_model(settings=ours_settings)
    jax_api.train(profile="fast", settings=theirs_settings)
    clip = corpus / "held_out.wav"
    return {
        "report": report,
        "ours": api.infer(clip, profile="fast", include_transcript=False, settings=ours_settings),
        "theirs": jax_api.infer(clip, profile="fast", include_transcript=False, settings=theirs_settings),
        "ours_by_jax": jax_api.infer(clip, profile="fast", include_transcript=False,
                                     settings=_small_head(_jax_settings(ours_env))),
        "theirs_by_us": api.infer(clip, profile="fast", include_transcript=False,
                                  settings=_small_head(build_settings(theirs_env))),
        "settings": ours_settings,
    }


def test_fast_train_then_infer_on_the_cpu(fast_round_trip) -> None:
    report, execution = fast_round_trip["report"], fast_round_trip["ours"]
    assert report["accuracy"] >= 0.9
    assert report["backend_id"] == "handcrafted" and Path(report["report_path"]).is_file()
    loaded = artifacts.load_model_artifact(report["model_path"], expected_profile="fast", device="cpu")
    assert loaded.artifact_metadata["device"] == "cpu"
    assert loaded.artifact_metadata["provenance"]["trainer"] == "fast_training"
    assert execution.backend_id == "handcrafted"
    assert execution.detailed_result.frames[0].emotion == "angry"  # code 05 of the held-out clip


def test_fast_artifacts_are_served_by_the_other_package(fast_round_trip) -> None:
    for a, b in (("ours", "ours_by_jax"), ("theirs", "theirs_by_us")):
        first, second = fast_round_trip[a].detailed_result, fast_round_trip[b].detailed_result
        assert [f.emotion for f in first.frames] == [f.emotion for f in second.frames]
        assert [(s.emotion, s.start_seconds, s.end_seconds) for s in first.segments] == [
            (s.emotion, s.start_seconds, s.end_seconds) for s in second.segments]


def test_fast_training_report_keeps_ser_tpu_keys_and_counts(fast_round_trip, corpus) -> None:
    ours = json.loads(fast_round_trip["settings"].models.training_report_file.read_text())
    theirs = json.loads((corpus / "fast-theirs" / "models" / "training_report.json").read_text())
    assert set(ours) == set(theirs)
    for key in ("profile", "backend_id", "dataset_corpus_samples", "dataset_effective_samples", "labels",
                "label_distribution", "train_samples", "test_samples", "feature_vector_size"):
        assert ours[key] == theirs[key], key
    assert ours["artifact_metadata"]["provenance"].keys() == theirs["artifact_metadata"]["provenance"].keys()


@pytest.mark.parametrize("profile", PROFILES)
def test_artifact_and_report_names_match_ser_tpu(profile) -> None:
    from ser_tpu._internal.config.schema import profile_artifact_file_names as jax_names

    model_id = {"fast": None, "medium": "facebook/wav2vec2-xls-r-300m", "accurate": WHISPER_ID,
                "accurate-research": "iic/emotion2vec_plus_large"}[profile]
    assert profile_artifact_file_names(profile=profile, model_id=model_id) == jax_names(profile=profile)


@pytest.mark.parametrize("gate", ["unrestricted", "denied", "flag-off", "env-allowlist", "persisted-consent"])
def test_build_provenance_metadata_matches_ser_tpu(gate, tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.delenv("SER_RESTRICTED_BACKENDS_CONSENT_FILE", raising=False)
    monkeypatch.setenv("SER_CODE_REVISION", "abc123")
    env = {
        "unrestricted": {},
        "denied": {"SER_ENABLE_RESTRICTED_BACKENDS": "1"},
        "flag-off": {"SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"},
        "env-allowlist": {"SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"},
        "persisted-consent": {"SER_ENABLE_RESTRICTED_BACKENDS": "1"},
    }[gate]
    if gate == "persisted-consent":
        rb.record_backend_consent("emotion2vec")
    backend_id, profile = ("handcrafted", "fast") if gate == "unrestricted" else ("emotion2vec", "accurate-research")
    ours = rb.build_provenance_metadata(settings=build_settings(env), backend_id=backend_id, profile=profile)
    theirs = jax_rb.build_provenance_metadata(settings=_jax_settings(env), backend_id=backend_id, profile=profile)
    assert len(ours.pop("dependency_manifest_fingerprint")) == len(theirs.pop("dependency_manifest_fingerprint")) == 16
    assert ours == theirs
    assert ours["code_revision"] == "abc123"


def test_a_retrained_fast_head_is_served_at_once(fast_round_trip, corpus) -> None:
    settings = fast_round_trip["settings"]
    held_out = corpus / "held_out.wav"
    assert fast_round_trip["ours"].detailed_result.frames[0].emotion == "angry"
    # The second corpus holds two classes only: the retrained head cannot say "angry".
    subset = corpus / "two_classes"
    for path in sorted((corpus / "ds").glob("Actor_*/03-01-0[12]-*.wav")):
        (subset / path.parent.name).mkdir(parents=True, exist_ok=True)
        (subset / path.parent.name / path.name).write_bytes(path.read_bytes())
    retrained = dataclasses.replace(settings, dataset=dataclasses.replace(settings.dataset, folder=subset))
    api.train(profile="fast", settings=retrained)
    assert artifacts.load_model_artifact(settings.models.model_file, device="cpu").model.classes_.tolist() == [
        "calm", "neutral"]
    warm = api.infer(held_out, profile="fast", include_transcript=False, settings=retrained)
    assert {f.emotion for f in warm.detailed_result.frames} <= {"calm", "neutral"}
    cold = emotion_model.predict_emotions_detailed(str(held_out), settings=retrained)
    assert [f.probabilities for f in warm.detailed_result.frames] == [f.probabilities for f in cold.frames]


transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def tiny_whisper(corpus) -> Path:
    cfg = transformers.WhisperConfig(
        vocab_size=320, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=64, activation_function="gelu",
        decoder_start_token_id=1, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    torch.manual_seed(0)
    target = corpus / "cache" / "model-cache" / "huggingface" / WHISPER_ID
    transformers.WhisperModel(cfg).eval().save_pretrained(target, safe_serialization=True)
    return target


def test_accurate_train_then_infer_and_retrain_on_the_cpu(corpus, tiny_whisper, monkeypatch) -> None:
    monkeypatch.setattr(encoders, "_BACKEND_CACHE", {})
    env = _env(corpus, "accurate", SER_ENABLE_ACCURATE_PROFILE="1")
    settings = _small_head(build_settings(env), hidden_layer_sizes=(32,))
    api.train(profile="accurate", settings=settings)
    name, _, report_name = profile_artifact_file_names(profile="accurate", model_id=WHISPER_ID)
    report = (settings.models.folder / report_name).read_text()
    assert '"backend_id": "jax_whisper_encoder"' in report
    loaded = artifacts.load_model_artifact(settings.models.folder / name, expected_backend_id="jax_whisper_encoder",
                                           expected_profile="accurate", expected_model_id=WHISPER_ID, device="cpu")
    assert loaded.expected_feature_size == 128
    held_out = corpus / "held_out.wav"
    first = api.infer(held_out, profile="accurate", include_transcript=False, settings=settings)
    assert first.backend_id == "jax_whisper_encoder" and first.detailed_result.frames
    by_jax = jax_api.infer(held_out, profile="accurate", include_transcript=False,
                           settings=_small_head(_jax_settings(env), hidden_layer_sizes=(32,)))
    np.testing.assert_allclose(
        [list(f.probabilities.values()) for f in by_jax.detailed_result.frames],
        [list(f.probabilities.values()) for f in first.detailed_result.frames], atol=1e-4)

    retrained = _small_head(settings, hidden_layer_sizes=(16,), random_state=3)
    api.train(profile="accurate", settings=retrained)
    warm = api.infer(held_out, profile="accurate", include_transcript=False, settings=retrained)
    monkeypatch.setattr(encoders, "_BACKEND_CACHE", {})
    cold = api.infer(held_out, profile="accurate", include_transcript=False, settings=retrained)
    warm_p = [f.probabilities for f in warm.detailed_result.frames]
    assert warm_p == [f.probabilities for f in cold.detailed_result.frames]
    assert warm_p != [f.probabilities for f in first.detailed_result.frames]
