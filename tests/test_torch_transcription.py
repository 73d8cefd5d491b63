"""The transcript lane of the port against ``ser_tpu``, on the CPU.

- word timing (numpy DTW and the word merge) gives the same words and times;
- ``WhisperForTranscription.transcribe_words`` at ``WhisperConfig.tiny()`` in
  float32, with JAX's own parameters carried across, gives the same words and
  timestamps (1e-6) with ``RETRY_TEMPERATURES = ()`` on both, with and without
  VAD; the port decodes through the step kernels' plain versions, JAX through
  XLA's route;
- the temperature-retry loop makes the same choices on a scripted decode;
- REPET-SIM separation and the spectral gate agree at 1e-6;
- ``api.infer(include_transcript=True)`` with ``SER_TORCH_DEVICE=cpu`` on a
  staged tiny HF checkpoint gives the same transcript and timeline as
  ``ser_tpu.api.infer``, greedy and with ``WHISPER_DECODE_STRATEGY=beam``;
  the process-isolated route gives the in-process words. The JAX transcriber
  is asked for float32, the port's CPU dtype (the JAX lane's default request
  is bfloat16);
- the beam and isolation settings read and refuse like the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ser_tpu.api as jax_api
import ser_tpu_torch.api as torch_api
from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.transcript import base as jax_base
from ser_tpu._internal.transcript import extractor as jax_extractor
from ser_tpu._internal.transcript import hbm_admission as jax_admission
from ser_tpu._internal.transcript import profiling as jax_profiling
from ser_tpu._internal.utils import denoise as jax_denoise
from ser_tpu._internal.utils import source_separation as jax_separation
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.models import whisper as jax_whisper
from ser_tpu.models import word_timing as jax_timing
from ser_tpu.models.mlp_head import JaxMLPClassifier
import ser_tpu.profiles as jax_profiles
from ser_tpu_torch import profiles
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.transcript import extractor, hbm_admission, profiling
from ser_tpu_torch._internal.transcript.whisper_backend import WhisperTranscriber
from ser_tpu_torch._internal.utils import denoise, source_separation
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.models import word_timing
from ser_tpu_torch.domain import TranscriptWord
from ser_tpu_torch.models.whisper_tokenizer import WhisperTokenizer

transformers = pytest.importorskip("transformers")

TINY = torch_whisper.WhisperConfig.tiny()


class TinyTokenizer:
    """Special ids inside the tiny vocabulary; one word per token."""

    SPECIALS = {
        "<|startoftranscript|>": 200,
        "<|endoftext|>": 201,
        "<|en|>": 202,
        "<|transcribe|>": 203,
        "<|0.00|>": 210,
    }
    unk_token_id = 199

    def convert_tokens_to_ids(self, tokens):
        return [self.SPECIALS.get(token, self.unk_token_id) for token in tokens]

    def decode(self, ids):
        return "".join(f" t{i}" for i in ids)


# --------------------------------------------------------------------------- #
# Word timing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(7, 40), (1, 5), (30, 30), (12, 300)])
def test_dtw_path_matches_jax(shape) -> None:
    cost = np.random.default_rng(sum(shape)).standard_normal(shape)
    ours = word_timing.dtw_path(cost)
    ref = jax_timing.dtw_path(cost)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])


def test_word_timings_match_jax() -> None:
    rng = np.random.default_rng(11)
    tokens = [5, 17, 210, 44, 45, 9, 230, 3, 60]
    attention = rng.random((3, len(tokens), 200)).astype(np.float32)
    kwargs = dict(num_frames=150, timestamp_begin=210)
    ours = word_timing.word_timings_from_alignment(attention, tokens, TinyTokenizer(), **kwargs)
    ref = jax_timing.word_timings_from_alignment(attention, tokens, TinyTokenizer(), **kwargs)
    assert [(w.word, w.start, w.end) for w in ours] == [(w.word, w.start, w.end) for w in ref]
    assert len(ours) == 7


def test_median_filter_matches_jax() -> None:
    x = np.random.default_rng(2).standard_normal((2, 5, 33))
    np.testing.assert_array_equal(word_timing.median_filter(x, 7), jax_timing.median_filter(x, 7))


# --------------------------------------------------------------------------- #
# transcribe_words against JAX
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny_models():
    jax_config = jax_whisper.WhisperConfig.tiny()
    encoder_params = jax.tree_util.tree_map(np.asarray, jax_whisper.init_whisper_encoder_params(jax_config, seed=0))
    decoder_params = jax_whisper.WhisperDecoder(jax_config).init(
        jax.random.PRNGKey(1),
        np.zeros((1, jax_config.max_target_positions), np.int32),
        np.zeros((1, jax_whisper.CHUNK_FRAMES // 2, jax_config.d_model), np.float32),
    )["params"]
    decoder_params = jax.tree_util.tree_map(np.asarray, decoder_params)
    rng = np.random.default_rng(5)
    decoder_params["pos_embed"] = (0.05 * rng.standard_normal(decoder_params["pos_embed"].shape)).astype(np.float32)
    reference = jax_whisper.WhisperForTranscription(
        jax_config, encoder_params, decoder_params, TinyTokenizer(), compute_dtype="float32"
    )
    ported = torch_whisper.WhisperForTranscription(
        TINY,
        convert.whisper_encoder_state_dict(encoder_params),
        convert.whisper_decoder_state_dict(decoder_params),
        TinyTokenizer(),
        device="cpu",
    )
    reference.RETRY_TEMPERATURES = ()
    ported.RETRY_TEMPERATURES = ()
    return reference, ported


def _speechlike(seconds: float, seed: int, *, lead_silence: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * t / 3.0)
    audio = envelope * (np.sin(2 * np.pi * 190 * t) + 0.3 * rng.standard_normal(t.size))
    audio = np.concatenate([np.zeros(int(lead_silence * 16000)), audio])
    return (0.3 * audio).astype(np.float32)


def _assert_same_words(ours, ref) -> None:
    assert [w.word for w in ours] == [w.word for w in ref]
    for a, b in zip(ours, ref):
        assert abs(a.start_seconds - b.start_seconds) <= 1e-6
        assert abs(a.end_seconds - b.end_seconds) <= 1e-6


@pytest.mark.parametrize(
    ("seconds", "lead_silence", "use_vad"),
    [(42.0, 0.0, False), (12.0, 2.5, True)],
    ids=["two-windows", "vad-offset"],
)
def test_transcribe_words_matches_jax(tiny_models, seconds, lead_silence, use_vad) -> None:
    reference, ported = tiny_models
    audio = _speechlike(seconds, seed=3, lead_silence=lead_silence)
    ref = reference.transcribe_words(audio, use_vad=use_vad)
    ours = ported.transcribe_words(audio, use_vad=use_vad)
    assert len(ours) > 10
    _assert_same_words(ours, ref)
    if use_vad:
        assert ours[0].start_seconds >= 2.5 - 512 / 16000


def test_interpolated_words_when_alignment_is_off(tiny_models) -> None:
    reference, ported = tiny_models
    audio = _speechlike(8.0, seed=4)
    reference.word_timestamps = ported.word_timestamps = "interpolate"
    try:
        _assert_same_words(ported.transcribe_words(audio, use_vad=False), reference.transcribe_words(audio, use_vad=False))
    finally:
        reference.word_timestamps = ported.word_timestamps = "align"


def test_trim_silence_matches_jax() -> None:
    for audio in (_speechlike(3.0, 1, lead_silence=1.2), np.zeros(4000, np.float32), np.ones(100, np.float32)):
        ours_audio, ours_offset = torch_whisper._trim_silence(audio)
        ref_audio, ref_offset = jax_whisper._trim_silence(audio)
        assert ours_offset == ref_offset
        np.testing.assert_array_equal(ours_audio, ref_audio)


@pytest.mark.parametrize("text", ["", "short text", "the cat " * 20, "a quick brown fox jumps over lazy dogs"])
def test_degeneracy_signals_match_jax(text) -> None:
    assert torch_whisper.transcript_compression_ratio(text) == jax_whisper.transcript_compression_ratio(text)
    assert torch_whisper.transcript_is_degenerate(text) == jax_whisper.transcript_is_degenerate(text)


def test_retry_loop_matches_jax_on_a_scripted_decode(tiny_models) -> None:
    """Window 0 is fine, window 1 repeats itself; the retries at 0.2 and 0.5
    give a worse and a better candidate, and the loop keeps the better one."""
    reference, ported = tiny_models
    repetitive = [5, 6] * 20
    script = {
        0.2: [[7, 7, 7, 7] * 12],
        0.5: [[11, 23, 35, 47, 59, 71, 83, 95, 107, 119, 131, 143]],
        0.8: [[5] * 40],
    }
    calls = []

    def scripted(states, language, num_frames, *, temperature=0.0, rng_seed=0):
        calls.append((temperature, rng_seed, len(num_frames)))
        matrices = np.full((len(num_frames), 4, 6), temperature, dtype=np.float32)
        return [list(tokens) for tokens in script[temperature]], matrices

    results = {}
    for name, model in (("jax", reference), ("torch", ported)):
        calls.clear()
        model.RETRY_TEMPERATURES = (0.2, 0.5, 0.8)
        model._decode_chunk_batch = scripted
        try:
            states = np.zeros((2, 3, 4), np.float32) if name == "jax" else torch.zeros(2, 3, 4)
            emitted, matrices = model._retry_degenerate_chunks(
                states, "en", np.array([100, 80]), [[1, 2, 3], list(repetitive)], np.zeros((2, 4, 6), np.float32)
            )
        finally:
            del model._decode_chunk_batch
            model.RETRY_TEMPERATURES = ()
        results[name] = (emitted, np.asarray(matrices), list(calls))
    assert results["torch"][0] == results["jax"][0] == [[1, 2, 3], script[0.5][0]]
    np.testing.assert_array_equal(results["torch"][1], results["jax"][1])
    assert results["torch"][2] == results["jax"][2] == [(0.2, 1, 1), (0.5, 2, 1)]


def test_unported_decode_options_raise() -> None:
    """Beam search and the int8 decode stream, once refused, build as the JAX
    package's options do; an unknown strategy is still refused."""
    state = torch_whisper.random_whisper_encoder_state(TINY, seed=0)
    dec = torch_whisper.random_whisper_decoder_state(TINY, seed=0)
    beam = torch_whisper.WhisperForTranscription(
        TINY, state, dec, TinyTokenizer(), device="cpu", decode_strategy="beam", beam_size=4, length_penalty=0.5
    )
    assert (beam.decode_strategy, beam.beam_size, beam.length_penalty, beam.decode_int8) == ("beam", 4, 0.5, False)
    assert beam.decode_weights().fused is not None and beam.decode_weights().quant is None
    quantized = torch_whisper.WhisperForTranscription(TINY, state, dec, TinyTokenizer(), device="cpu", decode_int8=True)
    assert quantized.decode_int8 and quantized.decode_weights().quant is not None
    with pytest.raises(ValueError, match="decode strategy"):
        torch_whisper.WhisperForTranscription(TINY, state, dec, TinyTokenizer(), device="cpu", decode_strategy="mcts")


# --------------------------------------------------------------------------- #
# Separation and denoise
# --------------------------------------------------------------------------- #


def _music_and_voice(seconds: float = 6.0) -> np.ndarray:
    rng = np.random.default_rng(9)
    t = np.arange(int(seconds * 16000)) / 16000
    beat = np.sin(2 * np.pi * 110 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
    voice = np.sin(2 * np.pi * (220 + 40 * np.sin(2 * np.pi * 0.7 * t)) * t) * (t > 2.0)
    return (0.4 * beat + 0.3 * voice + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def test_repet_sim_matches_jax() -> None:
    audio = _music_and_voice()
    ours = source_separation.separate_vocals(audio, 16000)
    ref = jax_separation.separate_vocals(audio, 16000)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_spectral_gate_matches_jax() -> None:
    audio = _music_and_voice(4.0)
    np.testing.assert_allclose(denoise.spectral_gate_denoise(audio), jax_denoise.spectral_gate_denoise(audio), atol=1e-6)


def test_separation_routing(tmp_path, monkeypatch) -> None:
    """A missing checkpoint takes REPET-SIM; a staged one takes the neural lane, which with no card
    raises unless the CPU is asked for (``tests/test_torch_separation.py`` holds the neural lane)."""
    audio = _music_and_voice(3.0)
    monkeypatch.delenv("SER_SEPARATION_MODEL_PATH", raising=False)
    monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    missing = tmp_path / "absent.npz"
    np.testing.assert_array_equal(
        source_separation.separate_vocals_auto(audio, 16000, model_path=missing),
        source_separation.separate_vocals(audio, 16000),
    )
    staged = tmp_path / "demucs.npz"
    staged.write_bytes(b"not a checkpoint")
    monkeypatch.setenv("SER_SEPARATION_MODEL_PATH", str(staged))
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        source_separation.separate_vocals_auto(audio, 16000)


# --------------------------------------------------------------------------- #
# Settings, catalog and admission
# --------------------------------------------------------------------------- #


def test_catalog_transcription_defaults_match_jax() -> None:
    ours = profiles.require_ported("accurate").transcription_defaults
    ref = jax_profiles.get_profile_catalog()["accurate"].transcription_defaults
    assert vars(ours) == vars(ref)


def test_whisper_variables_read_like_jax(tmp_path) -> None:
    env = {
        "WHISPER_BACKEND": "jax_whisper",
        "WHISPER_MODEL": "small.en",
        "WHISPER_DEMUCS": "1",
        "WHISPER_VAD": "false",
        "WHISPER_DECODE_STRATEGY": "greedy",
        "SER_SEPARATION_MODEL_PATH": str(tmp_path / "sep.npz"),
        "SER_CACHE_DIR": str(tmp_path / "cache"),
    }
    ours = build_settings(env)
    ref = build_settings_from_inputs(capture_settings_inputs(env))
    for name in ("backend_id", "use_demucs", "use_vad", "decode_strategy", "separation_model_path"):
        assert getattr(ours.transcription, name) == getattr(ref.transcription, name), name
    assert ours.models.whisper_model.name == ref.models.whisper_model.name == "small.en"
    assert ours.models.whisper_download_root == ref.models.whisper_download_root
    assert ours.tmp_folder == ref.tmp_folder
    for name in ("hbm_admission_control_enabled", "hbm_admission_min_headroom_mb", "calibration_min_confidence"):
        assert getattr(ours.transcription, name) == getattr(ref.transcription, name), name


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"WHISPER_DECODE_STRATEGY": "beam", "WHISPER_BEAM_SIZE": "3", "WHISPER_LENGTH_PENALTY": "0.6"},
        {"WHISPER_BEAM_SIZE": "16", "WHISPER_LENGTH_PENALTY": "0", "SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT": "0"},
        {"SER_TRANSCRIPTION_MPS_HARD_OOM_SHORTCUT": "false", "SER_ACCURATE_PROCESS_ISOLATION": "1"},
    ],
)
def test_beam_and_isolation_variables_read_like_jax(env) -> None:
    ours = build_settings(env)
    ref = build_settings_from_inputs(capture_settings_inputs(env))
    for name in ("decode_strategy", "beam_size", "length_penalty", "hbm_hard_oom_shortcut_enabled",
                 "process_isolation", "isolation_timeout_seconds"):
        assert getattr(ours.transcription, name) == getattr(ref.transcription, name), name
    assert ours.accurate_runtime.process_isolation == ref.accurate_runtime.process_isolation


@pytest.mark.parametrize(
    ("env", "match"),
    [
        ({"WHISPER_BEAM_SIZE": "0"}, r"WHISPER_BEAM_SIZE must be in \[1, 16\]"),
        ({"WHISPER_BEAM_SIZE": "17"}, r"WHISPER_BEAM_SIZE must be in \[1, 16\]"),
        ({"WHISPER_LENGTH_PENALTY": "-0.5"}, r"WHISPER_LENGTH_PENALTY must be finite and in \[0, 5\]"),
        ({"WHISPER_LENGTH_PENALTY": "nan"}, r"WHISPER_LENGTH_PENALTY must be finite and in \[0, 5\]"),
        ({"WHISPER_LENGTH_PENALTY": "5.5"}, r"WHISPER_LENGTH_PENALTY must be finite and in \[0, 5\]"),
    ],
)
def test_beam_variables_are_refused_like_jax(env, match) -> None:
    with pytest.raises(ValueError, match=match):
        build_settings(env)
    with pytest.raises(ValueError, match=match):
        build_settings_from_inputs(capture_settings_inputs(env))


@pytest.mark.parametrize("name", ["tiny", "openai/whisper-small.en", "large-v3", "mystery"])
def test_footprint_estimate_matches_jax(name) -> None:
    assert hbm_admission.estimate_model_footprint_mb(name) == jax_admission.estimate_model_footprint_mb(name)


def test_calibration_override_matches_jax(tmp_path) -> None:
    recommendation = jax_profiling.CalibrationRecommendation(
        backend_id="jax_whisper", model_name="large", confidence="high", mean_wer=0.1,
        p50_latency_seconds=1.0, generated_at_unix=__import__("time").time(),
    )
    report = tmp_path / "transcription_calibration.json"
    jax_profiling.save_calibration_report(recommendation, [], report)
    ours = hbm_admission.calibration_admission_override(
        "large", build_settings({}).transcription, default_report_path=report
    )
    ref = jax_admission.calibration_admission_override(
        "large", build_settings_from_inputs(capture_settings_inputs({})).transcription, default_report_path=report
    )
    assert ours == ref and ours is not None
    assert profiling.default_calibration_report_path(tmp_path) == jax_profiling.default_calibration_report_path(tmp_path)
    decision = hbm_admission.admit_transcription_model("large", config=build_settings({}).transcription)
    assert decision.admitted and decision.free_memory_mb is None  # no card here
    report.write_text(json.dumps({"recommendation": {"confidence": "certain"}}))
    assert hbm_admission.load_calibration_report(report) is None


# --------------------------------------------------------------------------- #
# api.infer(include_transcript=True) against ser_tpu on a staged checkpoint
# --------------------------------------------------------------------------- #

MODEL_ID = "openai/whisper-large-v3"
LABELS = ["angry", "happy", "neutral", "sad"]
D_MODEL = 64


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)


def _attention(rng, sd, base, d):
    for proj in ("q_proj", "v_proj", "out_proj"):
        sd[f"{base}.{proj}.weight"] = _t(rng, d, d)
        sd[f"{base}.{proj}.bias"] = _t(rng, d)
    sd[f"{base}.k_proj.weight"] = _t(rng, d, d)  # Whisper's k_proj has no bias


def build_whisper_checkpoint(model_dir, *, seed: int = 0):
    """A tiny HF Whisper checkpoint with tokenizer and generation config
    (the layout of ``ser_tpu``'s checkpoint-loading test, copied)."""
    d, n_mels, layers, heads, vocab, max_len = D_MODEL, 80, 2, 4, 2048, 64
    rng = np.random.default_rng(seed)
    sd: dict = {
        "encoder.conv1.weight": _t(rng, d, n_mels, 3),
        "encoder.conv1.bias": _t(rng, d),
        "encoder.conv2.weight": _t(rng, d, d, 3),
        "encoder.conv2.bias": _t(rng, d),
        "encoder.layer_norm.weight": _t(rng, d),
        "encoder.layer_norm.bias": _t(rng, d),
        "decoder.embed_tokens.weight": _t(rng, vocab, d),
        "decoder.embed_positions.weight": _t(rng, max_len, d),
        "decoder.layer_norm.weight": _t(rng, d),
        "decoder.layer_norm.bias": _t(rng, d),
    }
    for i in range(layers):
        base = f"encoder.layers.{i}"
        _attention(rng, sd, f"{base}.self_attn", d)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{base}.{ln}.weight"] = _t(rng, d)
            sd[f"{base}.{ln}.bias"] = _t(rng, d)
        sd[f"{base}.fc1.weight"], sd[f"{base}.fc1.bias"] = _t(rng, 4 * d, d), _t(rng, 4 * d)
        sd[f"{base}.fc2.weight"], sd[f"{base}.fc2.bias"] = _t(rng, d, 4 * d), _t(rng, d)
    for i in range(layers):
        base = f"decoder.layers.{i}"
        _attention(rng, sd, f"{base}.self_attn", d)
        _attention(rng, sd, f"{base}.encoder_attn", d)
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            sd[f"{base}.{ln}.weight"] = _t(rng, d)
            sd[f"{base}.{ln}.bias"] = _t(rng, d)
        sd[f"{base}.fc1.weight"], sd[f"{base}.fc1.bias"] = _t(rng, 4 * d, d), _t(rng, 4 * d)
        sd[f"{base}.fc2.weight"], sd[f"{base}.fc2.bias"] = _t(rng, d, 4 * d), _t(rng, d)
    model_dir.mkdir(parents=True, exist_ok=True)
    torch.save(sd, model_dir / "pytorch_model.bin")
    (model_dir / "config.json").write_text(json.dumps({
        "num_mel_bins": n_mels, "d_model": d, "encoder_layers": layers, "decoder_layers": layers,
        "encoder_attention_heads": heads, "vocab_size": vocab, "max_target_positions": max_len,
    }))
    (model_dir / "generation_config.json").write_text(
        json.dumps({"alignment_heads": [[1, 0], [1, 2]], "suppress_tokens": [5, 3, 9]})
    )
    vocab_json = {chr(33 + index): index for index in range(80)}
    vocab_json["Ġw"] = 80
    (model_dir / "vocab.json").write_text(json.dumps(vocab_json))
    (model_dir / "merges.txt").write_text("#version: 0.2\n")
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"] + [
        f"<|{i / 100:.2f}|>" for i in range(0, 3001, 2)
    ]
    (model_dir / "added_tokens.json").write_text(json.dumps({token: 81 + i for i, token in enumerate(specials)}))
    (model_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "WhisperTokenizer", "unk_token": "<|endoftext|>",
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
    }))
    return model_dir


def _write_head_artifact(path) -> None:
    rng = np.random.default_rng(0)
    dims = [2 * D_MODEL, 32, len(LABELS)]
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [32], "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8,
        "max_iter": 500, "random_state": 42, "classes": LABELS,
        "weights": [(rng.standard_normal((a, b)) * 2.0 * np.sqrt(2.0 / (a + b))).astype(np.float32)
                    for a, b in zip(dims[:-1], dims[1:])],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]], "n_iter": 1, "loss": 1.0,
    }
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=2 * D_MODEL, training_samples=8, labels=LABELS, backend_id="jax_whisper_encoder",
        profile="accurate", pooling_strategy="mean_std", backend_model_id=MODEL_ID,
    )
    jax_artifacts.save_model_artifact(
        jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata), path
    )


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("transcript")
    cache, models = root / "cache", root / "models"
    # The emotion lane's encoder and the transcript lane's model load the same checkpoint.
    build_whisper_checkpoint(cache / "model-cache" / "huggingface" / MODEL_ID)
    build_whisper_checkpoint(cache / "model-cache" / "OpenAI" / "whisper" / "large")
    _write_head_artifact(models / profile_artifact_file_names(profile="accurate", accurate_model_id=MODEL_ID)[0])
    rng = np.random.default_rng(3)
    t = np.arange(int(40.0 * 22050)) / 22050
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    audio = mix * np.sin(2 * np.pi * 220 * t) + (1 - mix) * 0.5 * rng.standard_normal(t.size)
    clip = root / "clip.wav"
    write_wav(clip, (0.8 * audio / np.abs(audio).max()).astype(np.float32), 22050)
    env = {
        "SER_ENABLE_ACCURATE_PROFILE": "1",
        "SER_MODELS_FOLDER": str(models),
        "SER_CACHE_DIR": str(cache),
        "SER_TORCH_DEVICE": "cpu",
    }
    return {"env": env, "clip": clip}


@pytest.fixture(scope="module")
def transcript_runs(staged):
    env = staged["env"]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            jax_extractor,
            "_runtime_request",
            lambda resolved, settings: jax_base.BackendRuntimeRequest(
                model_name=resolved.model_name, use_demucs=resolved.use_demucs, use_vad=resolved.use_vad,
                precision_candidates=("float32",),
            ),
        )
        reference = jax_api.infer(
            staged["clip"], profile="accurate", include_transcript=True,
            settings=build_settings_from_inputs(capture_settings_inputs(env)),
        )
    ported = torch_api.infer(staged["clip"], profile="accurate", include_transcript=True, settings=build_settings(env))
    return reference, ported


def test_infer_with_transcript_matches_jax(transcript_runs) -> None:
    reference, ported = transcript_runs
    assert len(ported.transcript) > 5
    _assert_same_words(ported.transcript, reference.transcript)
    assert [tuple(s) for s in ported.emotions] == [tuple(s) for s in reference.emotions]
    assert [tuple(e) for e in ported.timeline] == [tuple(e) for e in reference.timeline]
    assert any(entry.speech for entry in ported.timeline)


def test_transcript_phases_are_recorded(transcript_runs) -> None:
    _, ported = transcript_runs
    assert {"transcription", "transcription_setup", "transcription_model_load", "timeline_build"} <= set(
        ported.phase_timings_seconds
    )


_BLOCKED_TRANSFORMERS_PROBE = r"""
import importlib.abc, json, sys


class RefuseTokenizerLibraries(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("transformers", "tokenizers"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, RefuseTokenizerLibraries())
try:
    import transformers  # noqa: F401
    blocked = False
except ImportError:
    blocked = True
import ser_tpu_torch.api as api
from ser_tpu_torch._internal.config.bootstrap import build_settings

execution = api.infer(sys.argv[2], profile="accurate", include_transcript=True, settings=build_settings(json.loads(sys.argv[1])))
print(json.dumps({
    "blocked": blocked,
    "loaded": sorted(name for name in sys.modules if name.split(".")[0] in ("transformers", "tokenizers")),
    "words": [[w.word, w.start_seconds, w.end_seconds] for w in execution.transcript],
}))
"""


def test_infer_with_transcript_runs_with_transformers_blocked(staged, transcript_runs) -> None:
    """A fresh interpreter that refuses ``transformers`` runs the port's ``api.infer(include_transcript=True)``
    on the staged checkpoint and gives ``ser_tpu``'s words (read through ``transformers``)."""
    reference, _ = transcript_runs
    repo_root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo_root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    completed = subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRANSFORMERS_PROBE, json.dumps(staged["env"]), str(staged["clip"])],
        cwd=repo_root, env=env, capture_output=True, text=True, timeout=240,
    )
    assert completed.returncode == 0, completed.stderr[-3000:]
    result = json.loads(completed.stdout.strip().splitlines()[-1])
    assert result["blocked"] and result["loaded"] == []
    words = [TranscriptWord(word=w, start_seconds=a, end_seconds=b) for w, a, b in result["words"]]
    assert len(words) > 5
    _assert_same_words(words, reference.transcript)


@pytest.mark.parametrize("entry", ["from_pretrained_dir", "WhisperTranscriber"])
def test_transcript_entry_points_default_to_the_card(staged, monkeypatch, entry: str) -> None:
    """With ``SER_TORCH_DEVICE`` unset and no card, the model loader and the transcriber raise (no silent
    CPU); with the CPU asked for, they run there, in float32."""
    model_dir = Path(staged["env"]["SER_CACHE_DIR"]) / "model-cache" / "OpenAI" / "whisper" / "large"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def build():
        if entry == "from_pretrained_dir":
            return torch_whisper.WhisperForTranscription.from_pretrained_dir(model_dir)
        transcriber = WhisperTranscriber(model_name="large", cache_root=model_dir.parent)
        transcriber.load_model()
        return transcriber._model

    monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        build()
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    model = build()
    assert model.device == torch.device("cpu") and model.compute_dtype == torch.float32
    assert next(model.decoder.parameters()).dtype == torch.float32


def test_from_pretrained_dir_reads_the_ports_tokenizer(staged, tmp_path) -> None:
    """The loader's tokenizer is the port's own, equal to ``transformers``'s on the staged files; a missing
    ``vocab.json`` raises ``FileNotFoundError`` naming it, which the transcriber's ``load_model`` reports as
    ``TranscriptionUnavailableError``."""
    model_dir = Path(staged["env"]["SER_CACHE_DIR"]) / "model-cache" / "OpenAI" / "whisper" / "large"
    model = torch_whisper.WhisperForTranscription.from_pretrained_dir(model_dir, device="cpu")
    assert isinstance(model.tokenizer, WhisperTokenizer)
    reference = transformers.WhisperTokenizer.from_pretrained(str(model_dir))
    ids = list(range(0, 1700, 7))
    assert model.tokenizer.decode(ids) == reference.decode(ids)
    broken = tmp_path / "large"
    shutil.copytree(model_dir, broken)
    (broken / "vocab.json").unlink()
    with pytest.raises(FileNotFoundError, match=str(broken / "vocab.json")):
        torch_whisper.WhisperForTranscription.from_pretrained_dir(broken, device="cpu")
    transcriber = WhisperTranscriber(model_name="large", cache_root=tmp_path, device="cpu")
    with pytest.raises(extractor.TranscriptionUnavailableError, match=str(broken / "vocab.json")):
        transcriber.load_model()


def test_missing_assets_and_isolation_raise(staged, tmp_path) -> None:
    """Missing assets and an unknown backend raise; process isolation, once
    refused, transcribes in a spawned worker on the CPU, word for word as the
    in-process run, and a worker's failure comes back as ``TranscriptionError``."""
    env = {**staged["env"], "WHISPER_MODEL": "medium"}
    with pytest.raises(extractor.TranscriptionUnavailableError, match="medium"):
        torch_api.infer(staged["clip"], profile="accurate", settings=build_settings(env))
    settings = build_settings(staged["env"])
    isolated = dataclasses.replace(
        settings, transcription=dataclasses.replace(settings.transcription, process_isolation=True)
    )
    words = extractor.extract_transcript(str(staged["clip"]), language="en", profile="accurate", settings=isolated)
    in_process = extractor.extract_transcript(str(staged["clip"]), language="en", profile="accurate", settings=settings)
    assert len(words) > 5
    _assert_same_words(words, in_process)
    missing = dataclasses.replace(isolated, models=dataclasses.replace(
        isolated.models, whisper_model=dataclasses.replace(isolated.models.whisper_model, name="medium")))
    with pytest.raises(extractor.TranscriptionError, match="Failed to transcribe"):
        extractor.extract_transcript(str(staged["clip"]), language="en", profile="accurate", settings=missing)
    with pytest.raises(extractor.TranscriptionUnavailableError, match="backend"):
        extractor.extract_transcript(
            str(staged["clip"]), language="en", profile="accurate",
            settings=dataclasses.replace(settings, transcription=dataclasses.replace(
                settings.transcription, backend_id="faster_whisper")),
        )


def test_infer_with_beam_transcript_matches_jax(staged) -> None:
    """Both packages' ``api.infer(include_transcript=True)`` with
    ``WHISPER_DECODE_STRATEGY=beam`` (beam 3) give the same words and times.

    The random checkpoint's beam transcript of this clip repeats itself, so
    both packages would retry it by temperature sampling, whose draws differ
    between the packages (``ROADMAP.md``, Queue 3): retries are off on both.
    """
    env = {**staged["env"], "WHISPER_DECODE_STRATEGY": "beam", "WHISPER_BEAM_SIZE": "3"}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_whisper.WhisperForTranscription, "RETRY_TEMPERATURES", ())
        patch.setattr(torch_whisper.WhisperForTranscription, "RETRY_TEMPERATURES", ())
        patch.setattr(
            jax_extractor,
            "_runtime_request",
            lambda resolved, settings: jax_base.BackendRuntimeRequest(
                model_name=resolved.model_name, use_demucs=resolved.use_demucs, use_vad=resolved.use_vad,
                precision_candidates=("float32",),
            ),
        )
        reference = jax_api.infer(
            staged["clip"], profile="accurate", include_transcript=True,
            settings=build_settings_from_inputs(capture_settings_inputs(env)),
        )
        ported = torch_api.infer(
            staged["clip"], profile="accurate", include_transcript=True, settings=build_settings(env)
        )
    assert len(ported.transcript) > 5
    _assert_same_words(ported.transcript, reference.transcript)
    assert [tuple(e) for e in ported.timeline] == [tuple(e) for e in reference.timeline]

