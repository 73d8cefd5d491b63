"""The fast and accurate-research profiles of the port against ``ser_tpu``, end to end on the CPU.

- ``extract_frame_features`` of a clip whose last frame is shorter than 2048
  samples (librosa's small-signal path), and ``extract_feature_from_signal``,
  against ``ser_tpu``'s, family by family at the golden tolerances
  (``test_dsp_golden_fixtures.py``);
  device framing against host framing (``SER_FAST_DEVICE_FRAMING=0``), and
  chunks of a few rows against one batch: the same rows;
- ``api.infer(profile="fast")`` and ``api.infer(profile="accurate-research")``
  in both packages on the same clip and the same head artifact (the fast
  head in ``ser_model.pkl``; emotion2vec from a FunASR ``model.pt`` staged
  under the ModelScope root, behind an opened gate): the same labels and
  segment bounds, probabilities within ``PROB_TOL``;
- the catalog entries and settings of both profiles read as ``ser_tpu``'s;
  with no card and no CPU request, both profiles raise.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import ser_tpu.api as jax_api
import ser_tpu.profiles as jax_profiles
from ser_tpu._internal.config.schema import FeatureFlags as JaxFeatureFlags
from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.models.mlp_head import JaxMLPClassifier
from ser_tpu.ops import features as jax_features
import ser_tpu_torch.api as torch_api
from ser_tpu_torch import profiles
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
from ser_tpu_torch._internal.repr.emotion2vec_backend import Emotion2VecBackend
from ser_tpu_torch._internal.repr.handcrafted import HandcraftedBackend
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.ops import features

LABELS = ["angry", "happy", "neutral", "sad"]
RESEARCH_MODEL_ID = "iic/emotion2vec_plus_large"
#: Head probabilities of the two packages: the fast features agree to about
#: 1e-6 relative, the emotion2vec states to 1e-4 absolute (the encoder pin).
PROB_TOL = 1e-4
FAMILIES = {
    "mfcc": (slice(0, 40), 2e-3),
    "chroma": (slice(40, 52), 5e-3),
    "mel": (slice(52, 180), 2e-4),
    "contrast": (slice(180, 187), 2e-3),
    "tonnetz": (slice(187, 193), 5e-3),
}


def _clip_audio(seconds: float, sample_rate: int, seed: int) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    noise = np.random.default_rng(seed).standard_normal(t.size)
    tone = np.sin(2 * np.pi * (220 + 30 * np.floor(t / 2.0)) * t)
    audio = mix * tone + (1 - mix) * 0.5 * noise
    return (0.8 * audio / np.abs(audio).max()).astype(np.float32)


def _assert_families_close(ours: np.ndarray, reference: np.ndarray) -> None:
    for family, (cols, atol) in FAMILIES.items():
        np.testing.assert_allclose(
            ours[:, cols], reference[:, cols], rtol=2e-3, atol=atol * max(1.0, np.abs(reference[:, cols]).max()),
            err_msg=family,
        )


@pytest.fixture(scope="module")
def tail_clip() -> np.ndarray:
    """4 s + 1000 samples at 16 kHz: frames of 3, 3, 2.06, 1.06 s and one of 1000 samples."""
    return _clip_audio(4.0 + 1000 / 16000, 16000, seed=2)


def test_frame_features_with_a_short_tail_match_ser_tpu(tail_clip) -> None:
    ours, starts, ends = features.extract_frame_features(tail_clip, 16000, device="cpu")
    reference, ref_starts, ref_ends = jax_features.extract_frame_features(tail_clip, 16000)
    assert ours.shape == reference.shape == (5, 193)
    assert ends[-1] - starts[-1] == pytest.approx(1000 / 16000)
    np.testing.assert_array_equal(starts, ref_starts)
    np.testing.assert_array_equal(ends, ref_ends)
    _assert_families_close(ours, reference)
    assert features.feature_dim(JaxFeatureFlags()) == 193


def test_device_framing_equals_host_framing(tail_clip, monkeypatch) -> None:
    device_framed, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu")
    monkeypatch.setenv("SER_FAST_DEVICE_FRAMING", "0")
    host_framed, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu")
    np.testing.assert_array_equal(device_framed, host_framed)


def test_row_chunks_equal_one_batch(tail_clip, monkeypatch) -> None:
    whole, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu")
    monkeypatch.setattr(features, "_MAX_DEVICE_ROWS", 2)
    chunked, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu")
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-6 * np.abs(whole).max())


def test_feature_flags_select_families(tail_clip) -> None:
    flags = JaxFeatureFlags(mfcc=False, chroma=True, mel=False, contrast=False, tonnetz=True)
    ours, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu", feature_flags=flags)
    full, _, _ = features.extract_frame_features(tail_clip, 16000, device="cpu")
    assert ours.shape == (5, 18)
    np.testing.assert_allclose(ours, np.concatenate([full[:, 40:52], full[:, 187:193]], axis=1), atol=1e-6)


@pytest.mark.parametrize("samples", [300, 1500, 20000], ids=["padded_to_512", "small_signal", "batched"])
def test_whole_signal_vector_matches_ser_tpu(samples) -> None:
    """``extract_feature_from_signal`` (the training input) and the backend's ``extract_vector``."""
    audio = _clip_audio(samples / 16000, 16000, seed=samples)
    ours = features.extract_feature_from_signal(audio, 16000, device="cpu")
    reference = jax_features.extract_feature_from_signal(audio, 16000)
    assert ours.dtype == np.float64 and ours.shape == reference.shape == (193,)
    _assert_families_close(ours[None, :], np.asarray(reference)[None, :])
    np.testing.assert_array_equal(HandcraftedBackend(device="cpu").extract_vector(audio, 16000), ours)


def _write_head(path: Path, feature_matrix: np.ndarray, *, backend_id: str, profile: str,
                model_id: str | None, pooling: str) -> None:
    """A seeded ``ser_tpu_mlp`` head whose first layer standardizes the clip's own features.

    Centred and scaled on the clip's features, the windows' differences, not
    the features' common offset or scale, decide the labels, as a trained
    head's would.
    """
    rng = np.random.default_rng(0)
    size = feature_matrix.shape[1]
    mean, std = feature_matrix.mean(axis=0), feature_matrix.std(axis=0) + 1e-6
    w1 = (rng.standard_normal((size, 32)) * 3.0 / np.sqrt(size) / std[:, None]).astype(np.float32)
    w2 = (rng.standard_normal((32, len(LABELS))) * 3.0 / np.sqrt(32)).astype(np.float32)
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [32], "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8,
        "max_iter": 500, "random_state": 42, "classes": LABELS, "weights": [w1, w2],
        "biases": [(-mean @ w1).astype(np.float32), np.zeros(len(LABELS), dtype=np.float32)],
        "n_iter": 1, "loss": 1.0,
    }
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=size, training_samples=8, labels=LABELS, backend_id=backend_id, profile=profile,
        pooling_strategy=pooling, backend_model_id=model_id,
    )
    jax_artifacts.save_model_artifact(jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata),
                                      path)


def _jax_settings(env: dict):
    return build_settings_from_inputs(capture_settings_inputs(env))


def _compare(reference, ported, *, profile: str, backend_id: str, frames: int, prob_tol: float = PROB_TOL) -> None:
    assert ported.backend_id == reference.backend_id == backend_id
    assert ported.profile == reference.profile == profile
    assert [tuple(s) for s in ported.emotions] == [tuple(s) for s in reference.emotions]
    assert [tuple(e) for e in ported.timeline] == [tuple(e) for e in reference.timeline]
    ours, ref = ported.detailed_result.frames, reference.detailed_result.frames
    assert len(ours) == len(ref) == frames
    for mine, theirs in zip(ours, ref):
        assert (mine.start_seconds, mine.end_seconds, mine.emotion) == (
            theirs.start_seconds, theirs.end_seconds, theirs.emotion)
        assert abs(mine.confidence - theirs.confidence) <= prob_tol
        for label, probability in theirs.probabilities.items():
            assert abs(mine.probabilities[label] - probability) <= prob_tol
    segments, ref_segments = ported.detailed_result.segments, reference.detailed_result.segments
    assert [(s.emotion, s.start_seconds, s.end_seconds) for s in segments] == [
        (s.emotion, s.start_seconds, s.end_seconds) for s in ref_segments]
    for mine, theirs in zip(segments, ref_segments):
        assert abs(mine.confidence - theirs.confidence) <= prob_tol
    assert len({frame.emotion for frame in ours}) >= 2, "the clip should exercise more than one label"


# --------------------------------------------------------------------------- #
# api.infer(profile="fast")
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fast_staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("fast")
    clip, sample_rate = root / "clip.wav", 22050
    audio = _clip_audio(20.0, sample_rate, seed=3)
    write_wav(clip, audio, sample_rate)
    encoded = HandcraftedBackend(device="cpu").encode_sequence(audio, sample_rate)
    _write_head(root / "models" / "ser_model.pkl", np.asarray(encoded.embeddings, dtype=np.float64),
                backend_id="handcrafted", profile="fast", model_id=None, pooling="mean")
    env = {"SER_MODELS_FOLDER": str(root / "models"), "SER_CACHE_DIR": str(root / "cache"), "SER_TORCH_DEVICE": "cpu"}
    return {"env": env, "clip": clip}


@pytest.fixture(scope="module")
def fast_executions(fast_staged) -> tuple:
    env, clip = fast_staged["env"], fast_staged["clip"]
    reference = jax_api.infer(clip, profile="fast", include_transcript=False, settings=_jax_settings(env))
    ported = torch_api.infer(clip, profile="fast", include_transcript=False, settings=build_settings(env))
    return reference, ported


def test_fast_infer_matches_ser_tpu(fast_executions) -> None:
    reference, ported = fast_executions
    _compare(reference, ported, profile="fast", backend_id="handcrafted", frames=20)
    assert ported.transcript == reference.transcript == []


def test_fast_segments_merge_adjacent_labels(fast_executions) -> None:
    _, ported = fast_executions
    frames, segments = ported.detailed_result.frames, ported.detailed_result.segments
    assert sum(1 for a, b in zip(frames, frames[1:]) if a.emotion != b.emotion) == len(segments) - 1
    assert segments[0].start_seconds == 0.0 and segments[-1].end_seconds == frames[-1].end_seconds


def test_fast_without_an_artifact_is_unavailable(fast_staged, tmp_path) -> None:
    from ser_tpu_torch._internal.runtime.errors import ModelUnavailableError

    env = {**fast_staged["env"], "SER_MODELS_FOLDER": str(tmp_path)}
    with pytest.raises(ModelUnavailableError, match="ser_model.pkl"):
        torch_api.infer(fast_staged["clip"], profile="fast", include_transcript=False, settings=build_settings(env))


# --------------------------------------------------------------------------- #
# api.infer(profile="accurate-research")
# --------------------------------------------------------------------------- #


def _synthetic_funasr_checkpoint(directory: Path) -> None:
    """The JAX suite's FunASR-layout checkpoint, its weights scaled to 1/√fan_in."""
    suite = Path(__file__).resolve().parent / "suites/unit/models/test_emotion2vec_convert.py"
    spec = importlib.util.spec_from_file_location("emotion2vec_convert_suite", suite)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    model_dir = module.build_synthetic_checkpoint(directory)
    state = torch.load(model_dir / "model.pt", weights_only=True)
    state = {key: value / value[0].numel() ** 0.5 if value.ndim >= 2 else value for key, value in state.items()}
    torch.save(state, model_dir / "model.pt")


@pytest.fixture(scope="module")
def research_staged(tmp_path_factory) -> dict:
    """A 4 s clip: the synthetic front end strides 10 samples a frame, so 4 s is 6399 frames."""
    root = tmp_path_factory.mktemp("research")
    cache = root / "cache"
    modelscope = cache / "model-cache" / "modelscope" / "hub"
    _synthetic_funasr_checkpoint(modelscope / "iic")
    clip, sample_rate = root / "clip.wav", 16000
    audio = _clip_audio(4.0, sample_rate, seed=5)
    write_wav(clip, audio, sample_rate)
    backend = Emotion2VecBackend(model_id=RESEARCH_MODEL_ID, cache_root=cache / "model-cache" / "huggingface",
                                 modelscope_cache_root=modelscope, device="cpu")
    encoded = backend.encode_sequence(audio, sample_rate)
    windows = temporal_pooling_windows(encoded, window_size_seconds=1.0, window_stride_seconds=1.0)
    artifact = root / "models" / profile_artifact_file_names(
        profile="accurate-research", accurate_research_model_id=RESEARCH_MODEL_ID)[0]
    _write_head(artifact, mean_std_pool(encoded, windows), backend_id="emotion2vec", profile="accurate-research",
                model_id=RESEARCH_MODEL_ID, pooling="mean_std")
    env = {
        "SER_ENABLE_RESTRICTED_BACKENDS": "1",
        "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec",
        "SER_MODELS_FOLDER": str(root / "models"),
        "SER_CACHE_DIR": str(cache),
        "SER_TORCH_DEVICE": "cpu",
    }
    return {"env": env, "clip": clip}


def test_accurate_research_infer_matches_ser_tpu(research_staged, monkeypatch) -> None:
    """Both packages read the clip's same native bits; the test head's conditioning sets the probability bound.

    The head's first layer standardizes the clip's own pooled features
    (``_write_head``): its weights carry 1/σ of each feature over the clip's
    4 windows, and the smallest σ is about 5e-6, so 1/σ reaches about 2e5.
    Measured on this clip: the emotion2vec states differ by 2.4e-6, the pooled
    features the heads receive by 2.3e-7 (one float32 ulp of the feature
    scale), the standardized inputs by 1.3e-4, the logits by 1.7e-4 and the
    probabilities by 1.10e-4. The heads themselves agree on the same input
    within 1.5e-7, and rounding the features to float32 alone moves either
    head's probabilities by 2.0e-3: the growth is the head's conditioning, not
    a stage of the port. The bound on the probabilities is therefore derived
    from the measured feature difference Δx, in exact arithmetic:
    ReLU is 1-Lipschitz, so |Δh_j| ≤ Σ_i |W1_ij| |Δx_i| and
    |Δz_k| ≤ Σ_j |W2_jk| |Δh_j|; each row of the softmax Jacobian sums in
    absolute value to 2 p_i (1 - p_i) ≤ 1/2, so |Δp|∞ ≤ ½ max_k |Δz_k|, over
    the windows. ``PROB_TOL`` holds where it was set: the heads on the same
    input, and the fast profile.
    """
    from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

    received: dict[str, list[np.ndarray]] = {"jax": [], "port": []}
    for name, cls in (("jax", JaxMLPClassifier), ("port", TorchMLPClassifier)):
        predict_proba = cls.predict_proba

        def recording(self, X, _name=name, _predict_proba=predict_proba):
            received[_name].append(np.array(X, dtype=np.float64))
            return _predict_proba(self, X)

        monkeypatch.setattr(cls, "predict_proba", recording)
    env, clip = research_staged["env"], research_staged["clip"]
    reference = jax_api.infer(clip, profile="accurate-research", include_transcript=False, settings=_jax_settings(env))
    ported = torch_api.infer(clip, profile="accurate-research", include_transcript=False, settings=build_settings(env))
    (x_ref,), (x_port,) = received["jax"], received["port"]
    monkeypatch.undo()

    artifact = next((Path(env["SER_MODELS_FOLDER"])).glob("ser_model_accurate_research_*.pkl"))
    state = jax_artifacts.load_model_artifact(artifact).model.get_state()
    np.testing.assert_allclose(TorchMLPClassifier.from_state(state, device="cpu").predict_proba(x_ref),
                               np.asarray(JaxMLPClassifier.from_state(state).predict_proba(x_ref)), rtol=0, atol=PROB_TOL)
    delta = np.abs(x_port - x_ref)
    assert delta.max() <= 1e-4, "the pooled features break the encoder's pin"
    w1, w2 = (np.abs(np.asarray(w, dtype=np.float64)) for w in state["weights"])
    bound = 0.5 * float(((delta @ w1) @ w2).max())
    assert bound < 1e-2, f"the derived bound {bound} no longer says anything"
    _compare(reference, ported, profile="accurate-research", backend_id="emotion2vec", frames=4,
             prob_tol=max(PROB_TOL, bound))


@pytest.mark.parametrize("profile", ["fast", "accurate-research"])
def test_without_a_card_or_a_cpu_request_raises(fast_staged, research_staged, profile) -> None:
    staged = fast_staged if profile == "fast" else research_staged
    env = {key: value for key, value in staged["env"].items() if key != "SER_TORCH_DEVICE"}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        torch_api.infer(staged["clip"], profile=profile, include_transcript=False, settings=build_settings(env))


# --------------------------------------------------------------------------- #
# Catalog and settings
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("profile", ["fast", "accurate-research"])
def test_catalog_entry_matches_ser_tpu(profile) -> None:
    ours = profiles.require_ported(profile)
    reference = jax_profiles.get_profile_catalog()[profile]
    assert ours.backend_id == reference.backend_id
    assert ours.default_model_id == reference.model.default_model_id
    assert vars(ours.runtime_defaults) == vars(reference.runtime_defaults)
    assert vars(ours.transcription_defaults) == vars(reference.transcription_defaults)
    assert profiles.PROFILE_NAMES == tuple(jax_profiles.get_profile_catalog())


def test_settings_read_the_same_variables_as_ser_tpu(tmp_path) -> None:
    env = {
        "SER_ACCURATE_RESEARCH_MODEL_ID": "iic/emotion2vec_base",
        "SER_MODEL_FILE_NAME": "head.pkl",
        "SER_MODELS_FOLDER": str(tmp_path),
        "SER_CACHE_DIR": str(tmp_path / "cache"),
        "SER_ENABLE_RESTRICTED_BACKENDS": "yes",
        "SER_ALLOWED_RESTRICTED_BACKENDS": " emotion2vec , other ,",
        "SER_FAST_POST_SMOOTHING_WINDOW_FRAMES": "7",
        "SER_ACCURATE_RESEARCH_POOL_WINDOW_SIZE_SECONDS": "2.0",
    }
    mine, theirs = build_settings(env), _jax_settings(env)
    assert mine.models.accurate_research_model_id == theirs.models.accurate_research_model_id
    assert mine.profile_model_id("accurate-research") == "iic/emotion2vec_base"
    assert mine.profile_model_id("fast") is None
    assert mine.models.model_file == theirs.models.model_file == tmp_path / "head.pkl"
    assert mine.models.modelscope_cache_root == theirs.models.modelscope_cache_root
    assert mine.runtime_flags.restricted_backends is theirs.runtime_flags.restricted_backends is True
    assert mine.runtime_flags.allowed_restricted_backends == theirs.runtime_flags.allowed_restricted_backends
    assert vars(mine.feature_flags) == vars(theirs.feature_flags)
    for profile, runtime, reference in (("fast", mine.fast_runtime, theirs.fast_runtime),
                                        ("accurate-research", mine.accurate_research_runtime,
                                         theirs.accurate_research_runtime)):
        assert mine.profile_runtime(profile) == runtime
        for knob in vars(runtime):
            assert getattr(runtime, knob) == getattr(reference, knob), (profile, knob)
