"""The medium profile of the port against ``ser_tpu`` on the CPU.

The JAX package's tiny XLS-R weights carried across with ``convert.py``, the
same numpy-seeded clips, float32:

- ``chunked_encode`` of a 65 s clip (three chunks in one masked batch) and
  ``chunked_encode_many`` across buckets, against ``ser_tpu``'s at 1e-4, with
  identical timestamps; bucket invariance of the valid frames;
- the float32 retry, driven by a planted non-finite ``encode_batch``: the
  backend switches to float32 for good, as ``ser_tpu``'s does, and agrees
  with it;
- device pooling (``SER_DEVICE_POOLING=1``, here on CPU tensors) against host
  pooling below 1e-5 relative (``tests/suites/unit/pool/test_device_pooling.py``);
- ``api.infer(profile="medium")`` with ``SER_TORCH_DEVICE=cpu`` on a tiny HF
  checkpoint that both packages load, against ``ser_tpu.api.infer``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ser_tpu.api as jax_api
import ser_tpu.profiles as jax_profiles
from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.pool import mean_std_pool as jax_mean_std_pool
from ser_tpu._internal.repr import encoder_backend as jax_encoder_backend
from ser_tpu._internal.repr.wav2vec2_backend import XlsrBackend as JaxXlsrBackend
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.models import wav2vec2 as jax_w2v
from ser_tpu.models.mlp_head import JaxMLPClassifier
import ser_tpu_torch.api as torch_api
from ser_tpu_torch import profiles
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
from ser_tpu_torch._internal.pool.device_pool import device_mean_std_pool, is_device_embeddings
from ser_tpu_torch._internal.repr import encoder_backend
from ser_tpu_torch._internal.repr.encode_util import encode_clips
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch._internal.runtime import profile_execution
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import wav2vec2 as w2v

transformers = pytest.importorskip("transformers")

ATOL = 1e-4
MODEL_ID = "facebook/wav2vec2-xls-r-300m"
LABELS = ["angry", "happy", "neutral", "sad"]


def _clip(seconds: float, seed: int, sample_rate: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(seconds * sample_rate))).astype(np.float32)


@pytest.fixture(scope="module")
def weights() -> tuple:
    jax_cfg = jax_w2v.Wav2Vec2Config.tiny()
    model = jax_w2v.Wav2Vec2Encoder(jax_cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 4000), jnp.float32))["params"]
    return jax_cfg, w2v.Wav2Vec2Config(**dataclasses.asdict(jax_cfg)), params


def _backends(weights, dtype: str = "float32", tmp_path=None) -> tuple[XlsrBackend, JaxXlsrBackend]:
    jax_cfg, cfg, params = weights
    root = tmp_path if tmp_path is not None else "/nonexistent"
    ours = XlsrBackend(
        model_id=MODEL_ID, cache_root=root, device="cpu", dtype=dtype, config=cfg,
        state=convert.wav2vec2_state_dict(params),
    )
    ref = JaxXlsrBackend(model_id=MODEL_ID, cache_root=root, dtype=dtype, config=jax_cfg, params=params)
    return ours, ref


def _assert_same_sequence(ours, ref, atol: float = ATOL) -> None:
    assert ours.backend_id == ref.backend_id == "jax_xlsr"
    np.testing.assert_array_equal(ours.frame_start_seconds, ref.frame_start_seconds)
    np.testing.assert_array_equal(ours.frame_end_seconds, ref.frame_end_seconds)
    assert ours.embeddings.shape == ref.embeddings.shape
    np.testing.assert_allclose(ours.embeddings, np.asarray(ref.embeddings), atol=atol)


def test_chunk_plan_and_buckets_match_ser_tpu() -> None:
    for n in (1, 399, 16000, 16001, 480000, 480001, 65 * 16000, 10**7):
        assert encoder_backend.plan_chunks(n) == jax_encoder_backend.plan_chunks(n)
        assert encoder_backend.bucket_samples(n) == jax_encoder_backend.bucket_samples(n)
    assert encoder_backend.random_init_seed("jax_xlsr", MODEL_ID) == jax_encoder_backend.random_init_seed(
        "jax_xlsr", MODEL_ID
    )
    batch, lengths = np.zeros((3, 8), np.float32), np.array([8, 4, 2])
    assert encoder_backend.shard_chunk_batch(batch, lengths) == (batch, lengths, 3)


def test_chunked_encode_of_a_65_s_clip_matches_jax(weights) -> None:
    ours, ref = _backends(weights)
    audio = _clip(65.0, seed=1, sample_rate=22050)
    assert len(encoder_backend.plan_chunks(int(65.0 * 16000))) == 3
    _assert_same_sequence(ours.encode_sequence(audio, 22050), ref.encode_sequence(audio, 22050))


def test_chunked_encode_many_across_buckets_matches_jax(weights) -> None:
    ours, ref = _backends(weights)
    clips = [(_clip(seconds, seed), 16000) for seed, seconds in enumerate((0.7, 1.5, 3.2, 2.5))]
    assert {encoder_backend.bucket_samples(audio.size) for audio, _ in clips} == {16000, 32000, 64000}
    for mine, theirs in zip(encode_clips(ours, clips), ref.encode_sequences(clips), strict=True):
        _assert_same_sequence(mine, theirs)


def test_masked_batching_is_bucket_invariant(weights) -> None:
    """The same audio padded into the 2 s and the 4 s bucket gives the same valid frames."""
    ours, _ = _backends(weights)
    audio = _clip(1.5, seed=2)
    short, long = np.zeros((1, 32000), np.float32), np.zeros((1, 64000), np.float32)
    short[0, : audio.size] = audio
    long[0, : audio.size] = audio
    lengths = np.array([audio.size])
    n = ours._frames_for_length(audio.size)
    e_short = ours._encode_batch(short, lengths).numpy()
    e_long = ours._encode_batch(long, lengths).numpy()
    np.testing.assert_allclose(e_short[0, :n], e_long[0, :n], atol=ATOL)


def _plant_one_non_finite(backend, calls: list) -> None:
    """The backend's first encode returns NaN on every frame; later ones are its own."""
    encode = backend._encode_batch

    def planted(batch, lengths):
        out = encode(batch, lengths)
        calls.append(backend._dtype)
        if len(calls) == 1:
            out = out * float("nan")
        return out

    backend._encode_batch = planted


def test_non_finite_bf16_encode_retries_in_float32_for_good(weights) -> None:
    ours, ref = _backends(weights, dtype="bfloat16")
    ours_calls, ref_calls = [], []
    _plant_one_non_finite(ours, ours_calls)
    _plant_one_non_finite(ref, ref_calls)
    audio = _clip(3.0, seed=3)
    mine, theirs = ours.encode_sequence(audio, 16000), ref.encode_sequence(audio, 16000)
    assert ours_calls == [torch.bfloat16, torch.float32]
    assert ref_calls == [jnp.bfloat16, jnp.float32]
    assert ours.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in ours._model.parameters())
    _assert_same_sequence(mine, theirs)
    ours.encode_sequence(audio, 16000)  # every later encode stays float32
    assert ours_calls[-1] == torch.float32


def test_retry_takes_the_float32_encode_once_and_raises_if_it_fails_too() -> None:
    audio = _clip(2.0, seed=4)
    shapes = []

    def nan_encode(batch, lengths):
        shapes.append(batch.shape)
        return torch.full((batch.shape[0], 99, 3), float("nan"))

    switched = []

    def float32_encode():
        switched.append(True)
        return lambda batch, lengths: torch.ones((batch.shape[0], 99, 3))

    encoded = encoder_backend.chunked_encode(
        audio, 16000, encode_batch=nan_encode, frames_for_length=lambda n: (n - 400) // 320 + 1,
        backend_id="jax_xlsr", device="cpu", float32_encode_batch=float32_encode,
    )
    assert switched == [True] and shapes == [(1, 32000)]
    assert encoded.embeddings.shape == (99, 3) and np.all(encoded.embeddings == 1.0)
    with pytest.raises(ValueError, match="non-finite"):
        encoder_backend.chunked_encode(
            audio, 16000, encode_batch=nan_encode, frames_for_length=lambda n: (n - 400) // 320 + 1,
            backend_id="jax_xlsr", device="cpu",
        )
    with pytest.raises(ValueError, match="non-finite"):
        encoder_backend.chunked_encode_many(
            [(audio, 16000)], encode_batch=nan_encode, frames_for_length=lambda n: (n - 400) // 320 + 1,
            backend_id="jax_xlsr", device="cpu",
        )


def test_device_pooling_matches_host_pooling(weights, monkeypatch) -> None:
    ours, ref = _backends(weights)
    audio = _clip(4.5, seed=5)
    host = ours.encode_sequence(audio, 16000)
    monkeypatch.setenv("SER_DEVICE_POOLING", "1")
    on_device = ours.encode_sequence(audio, 16000)
    assert is_device_embeddings(on_device.embeddings) and not is_device_embeddings(host.embeddings)
    windows = temporal_pooling_windows(host, window_size_seconds=1.0, window_stride_seconds=1.0)
    pooled_host = mean_std_pool(host, windows)
    pooled_device = mean_std_pool(on_device, windows)
    assert pooled_device.dtype == np.float64 and pooled_device.shape == pooled_host.shape
    rel = np.abs(pooled_device - pooled_host) / (np.abs(pooled_host) + 1e-9)
    assert float(rel.max()) < 1e-5
    means = profile_execution._mean_pool(on_device, windows)
    np.testing.assert_allclose(means, profile_execution._mean_pool(host, windows), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pooled_host, jax_mean_std_pool(ref.encode_sequence(audio, 16000), windows), atol=ATOL)


def test_device_pool_keeps_the_shifted_variance_exact() -> None:
    """A large common offset: E[x²]−E[x]² would lose half the float32 mantissa; the shifted form must not."""
    rng = np.random.default_rng(0)
    embeddings = (5.0 + 0.05 * rng.standard_normal((50, 7))).astype(np.float32)
    starts = np.arange(50, dtype=np.float64) * 0.1
    sequence = encoder_backend.EncodedSequence(
        embeddings=embeddings, frame_start_seconds=starts, frame_end_seconds=starts + 0.1, backend_id="test"
    )
    windows = temporal_pooling_windows(sequence, window_size_seconds=1.0, window_stride_seconds=1.0)
    device = dataclasses.replace(sequence, embeddings=torch.from_numpy(embeddings))
    rel = np.abs(device_mean_std_pool(device, windows) - mean_std_pool(sequence, windows))
    assert float((rel / (np.abs(mean_std_pool(sequence, windows)) + 1e-9)).max()) < 1e-5


# --------------------------------------------------------------------------- #
# api.infer(profile="medium")
# --------------------------------------------------------------------------- #


def _write_hf_checkpoint(model_dir) -> None:
    """Tiny widths, XLS-R's layout and its 7-layer front end (320-sample frames)."""
    cfg = transformers.Wav2Vec2Config(
        vocab_size=32,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        conv_dim=[32] * 7,
        conv_kernel=[10, 3, 3, 3, 3, 2, 2],
        conv_stride=[5, 2, 2, 2, 2, 2, 2],
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        feat_extract_norm="layer",
        conv_bias=True,
        do_stable_layer_norm=True,
        apply_spec_augment=False,
    )
    torch.manual_seed(0)
    transformers.Wav2Vec2Model(cfg).eval().save_pretrained(model_dir, safe_serialization=True)


def _write_head_artifact(path, feature_mean: np.ndarray) -> None:
    """A seeded head whose first layer is centred on the clip's mean pooled features.

    Centring keeps the windows' differences, not their common offset, in
    charge of the labels, as a trained head's biases would.
    """
    rng = np.random.default_rng(0)
    dims = [2 * 64, 32, len(LABELS)]
    weights = [
        (rng.standard_normal((a, b)) * 8.0 * np.sqrt(2.0 / (a + b))).astype(np.float32)
        for a, b in zip(dims[:-1], dims[1:])
    ]
    state = {
        "kind": "ser_tpu_mlp",
        "hidden_layer_sizes": [32],
        "alpha": 0.01,
        "batch_size": 256,
        "epsilon": 1e-8,
        "max_iter": 500,
        "random_state": 42,
        "classes": LABELS,
        "weights": weights,
        "biases": [(-feature_mean @ weights[0]).astype(np.float32), np.zeros(dims[2], dtype=np.float32)],
        "n_iter": 1,
        "loss": 1.0,
    }
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=2 * 64,
        training_samples=8,
        labels=LABELS,
        backend_id="jax_xlsr",
        profile="medium",
        pooling_strategy="mean_std",
        backend_model_id=MODEL_ID,
    )
    envelope = jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata)
    jax_artifacts.save_model_artifact(envelope, path)


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("medium")
    cache, models = root / "cache", root / "models"
    model_dir = cache / "model-cache" / "huggingface" / MODEL_ID
    _write_hf_checkpoint(model_dir)
    clip = root / "clip.wav"
    sample_rate = 22050
    t = np.arange(int(45.0 * sample_rate)) / sample_rate
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    noise = np.random.default_rng(3).standard_normal(t.size)
    audio = mix * np.sin(2 * np.pi * 220 * t) + (1 - mix) * 0.5 * noise
    audio = (0.8 * audio / np.abs(audio).max()).astype(np.float32)
    write_wav(clip, audio, sample_rate)
    backend = XlsrBackend(model_id=MODEL_ID, cache_root=cache / "model-cache" / "huggingface", device="cpu")
    encoded = backend.encode_sequence(audio, sample_rate)
    windows = temporal_pooling_windows(encoded, window_size_seconds=1.0, window_stride_seconds=1.0)
    feature_mean = mean_std_pool(encoded, windows).mean(axis=0)
    _write_head_artifact(
        models / profile_artifact_file_names(profile="medium", medium_model_id=MODEL_ID)[0], feature_mean
    )
    env = {
        "SER_ENABLE_MEDIUM_PROFILE": "1",
        "SER_MODELS_FOLDER": str(models),
        "SER_CACHE_DIR": str(cache),
        "SER_TORCH_DEVICE": "cpu",
    }
    return {"env": env, "clip": clip}


@pytest.fixture(scope="module")
def executions(staged) -> tuple:
    env = staged["env"]
    reference = jax_api.infer(
        staged["clip"], profile="medium", include_transcript=False,
        settings=build_settings_from_inputs(capture_settings_inputs(env)),
    )
    ported = torch_api.infer(staged["clip"], profile="medium", include_transcript=False, settings=build_settings(env))
    return reference, ported


def test_medium_infer_gives_the_segments_of_ser_tpu(executions) -> None:
    reference, ported = executions
    assert ported.backend_id == reference.backend_id == "jax_xlsr"
    assert ported.profile == reference.profile == "medium"
    assert [tuple(s) for s in ported.emotions] == [tuple(s) for s in reference.emotions]
    assert [tuple(e) for e in ported.timeline] == [tuple(e) for e in reference.timeline]
    assert ported.transcript == reference.transcript == []


def test_medium_frames_match_within_tolerance(executions) -> None:
    reference, ported = executions
    ours, ref = ported.detailed_result.frames, reference.detailed_result.frames
    assert len(ours) == len(ref) == 45
    for mine, theirs in zip(ours, ref):
        assert (mine.start_seconds, mine.end_seconds, mine.emotion) == (
            theirs.start_seconds,
            theirs.end_seconds,
            theirs.emotion,
        )
        for label, probability in theirs.probabilities.items():
            assert abs(mine.probabilities[label] - probability) <= 1e-5
    assert len({frame.emotion for frame in ours}) >= 2, "the clip should exercise more than one label"


def test_medium_without_a_card_or_a_cpu_request_raises(staged) -> None:
    env = {key: value for key, value in staged["env"].items() if key != "SER_TORCH_DEVICE"}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        torch_api.infer(staged["clip"], profile="medium", include_transcript=False, settings=build_settings(env))


def test_medium_catalog_entry_and_settings_match_ser_tpu() -> None:
    ours = profiles.require_ported("medium")
    reference = jax_profiles.get_profile_catalog()["medium"]
    assert "medium" in profiles.PROFILE_NAMES
    assert ours.backend_id == reference.backend_id == "jax_xlsr"
    assert ours.default_model_id == reference.model.default_model_id == MODEL_ID
    assert vars(ours.runtime_defaults) == vars(reference.runtime_defaults)
    assert vars(ours.transcription_defaults) == vars(reference.transcription_defaults)
    assert ours.transcription_defaults.model_name == "turbo"
    env = {
        "SER_MEDIUM_MODEL_ID": "org/xlsr-variant",
        "SER_MEDIUM_POOL_WINDOW_SIZE_SECONDS": "2.0",
        "SER_MEDIUM_POST_SMOOTHING_WINDOW_FRAMES": "5",
    }
    mine, theirs = build_settings(env), build_settings_from_inputs(capture_settings_inputs(env))
    assert mine.models.medium_model_id == theirs.models.medium_model_id == "org/xlsr-variant"
    assert mine.profile_model_id("medium") == "org/xlsr-variant"
    for knob in ("pool_window_size_seconds", "post_smoothing_window_frames"):
        assert getattr(mine.medium_runtime, knob) == getattr(theirs.medium_runtime, knob), knob
    assert mine.profile_runtime("medium") == mine.medium_runtime


def test_random_init_needs_the_switch(tmp_path, monkeypatch) -> None:
    monkeypatch.delenv("SER_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(RuntimeDependencyError, match="SER_ALLOW_RANDOM_INIT"):
        XlsrBackend(model_id=MODEL_ID, cache_root=tmp_path, device="cpu")
    monkeypatch.setenv("SER_ALLOW_RANDOM_INIT", "1")
    backend = XlsrBackend(model_id=MODEL_ID, cache_root=tmp_path, device="cpu", dtype="bfloat16")
    assert backend.feature_dim == 64 and backend.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in backend._model.parameters())


def test_medium_transcript_defaults_match_ser_tpu(staged) -> None:
    """A medium request's transcript lane: the catalog's ``turbo``, with separation and VAD, as in ``ser_tpu``."""
    from ser_tpu._internal.api.runtime import apply_cli_profile_override as jax_override
    from ser_tpu._internal.transcript.extractor import resolve_transcription_profile as jax_resolve
    from ser_tpu_torch._internal.api.runtime import apply_cli_profile_override
    from ser_tpu_torch._internal.transcript.extractor import resolve_transcription_profile

    env = staged["env"]
    ours = resolve_transcription_profile("medium", apply_cli_profile_override(build_settings(env), "medium"))
    theirs = jax_resolve(
        "medium", jax_override(build_settings_from_inputs(capture_settings_inputs(env)), "medium")
    )
    assert (ours.backend_id, ours.model_name, ours.use_demucs, ours.use_vad) == (
        theirs.backend_id,
        theirs.model_name,
        theirs.use_demucs,
        theirs.use_vad,
    ) == ("jax_whisper", "turbo", True, True)
