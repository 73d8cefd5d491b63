"""The plain references against the port on the CPU: the same seeded weights, the same front end."""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench.harness import spec
from portbench.reference import postprocess, wav2vec2, whisper
from portbench.tests.conftest import TINY


def _config(name: str) -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_whisper_shapes_follow_the_port_at_full_size():
    from ser_tpu_torch.models import whisper as port

    config = _config("whisper-large-v3")
    with torch.device("meta"):
        theirs = [(n, tuple(t.shape)) for n, t in port.WhisperEncoder(port.WhisperConfig()).state_dict().items()]
    assert whisper.parameter_shapes(config) == theirs


def test_wav2vec2_shapes_follow_the_port_at_full_size():
    from ser_tpu_torch.models import wav2vec2 as port

    config = _config("xlsr-300m")
    with torch.device("meta"):
        theirs = [(n, tuple(t.shape)) for n, t in port.Wav2Vec2Encoder(port.Wav2Vec2Config()).state_dict().items()]
    assert wav2vec2.parameter_shapes(config) == theirs


def test_draws_are_the_ports():
    from ser_tpu_torch._internal.repr.encoder_backend import random_init_seed
    from ser_tpu_torch.models import wav2vec2 as port_w2v
    from ser_tpu_torch.models import whisper as port_whisper

    assert whisper.init_seed("jax_xlsr", "facebook/wav2vec2-xls-r-300m") == \
        random_init_seed("jax_xlsr", "facebook/wav2vec2-xls-r-300m")
    cpu = torch.device("cpu")
    ours = whisper.draw_weights(_config("whisper-large-v3") | TINY["whisper"], 5, cpu)
    theirs = port_whisper.random_whisper_encoder_state(port_whisper.WhisperConfig.tiny(), seed=5, device=cpu)
    assert ours.keys() == theirs.keys() and all(torch.equal(ours[k], theirs[k]) for k in ours)
    ours = wav2vec2.draw_weights(_config("xlsr-300m") | TINY["wav2vec2"], 5, cpu)
    theirs = port_w2v.random_wav2vec2_state(port_w2v.Wav2Vec2Config.tiny(), seed=5, device=cpu)
    assert ours.keys() == theirs.keys() and all(torch.equal(ours[k], theirs[k]) for k in ours)


def test_log_mel_matches_the_ports_plain_route():
    from ser_tpu_torch.models import whisper as port

    rng = np.random.default_rng(3)
    wave = rng.standard_normal((1, whisper.WINDOW_SAMPLES)) * 0.1
    ours = whisper.log_mel(torch.from_numpy(wave), 128)
    theirs = port.log_mel_spectrogram(torch.from_numpy(wave).float(), 128)
    assert (ours - theirs.double()).abs().max().item() < 1e-4


def test_mel_filterbank_is_slaneys():
    from ser_tpu_torch.ops import filters

    assert np.abs(whisper.mel_filterbank(128) - filters.mel_filterbank(16000, 400, 128)).max() < 1e-6


def test_postprocessing_matches_the_ports():
    from ser_tpu_torch._internal.runtime.postprocessing import (
        SegmentPostprocessingConfig,
        postprocess_frame_predictions,
    )
    from ser_tpu_torch.runtime.schema import FramePrediction

    runtime = _config("whisper-large-v3")["runtime"]
    rng = np.random.default_rng(9)
    labels = ["a", "b", "c"]
    frames = []
    for i in range(200):
        p = rng.dirichlet([0.4, 0.4, 0.4])
        frames.append({"start": float(i), "end": float(i + 1) if i % 17 else i + 0.3, "emotion": labels[int(p.argmax())],
                       "confidence": float(p.max()), "probabilities": dict(zip(labels, map(float, p)))})
    theirs = postprocess_frame_predictions(
        [FramePrediction(f["start"], f["end"], f["emotion"], f["confidence"], f["probabilities"]) for f in frames],
        config=SegmentPostprocessingConfig(runtime["post_smoothing_window_frames"],
                                           runtime["post_hysteresis_enter_confidence"],
                                           runtime["post_hysteresis_exit_confidence"],
                                           runtime["post_min_segment_duration_seconds"]))
    ours = postprocess.segments(frames, runtime)
    assert [(s["emotion"], s["start"], s["end"], s["confidence"], s["probabilities"]) for s in ours] == \
        [(s.emotion, s.start_seconds, s.end_seconds, s.confidence, s.probabilities) for s in theirs]
    assert len(ours) > 3


def test_control_products_are_coarser_than_bf16():
    from portbench.reference import precision

    x, w = torch.randn(64, 256, dtype=torch.float32), torch.randn(128, 256) / 16
    exact = x @ w.T
    lowered = precision.int8_linear(x, w, None)
    bf16 = (x.bfloat16() @ w.bfloat16().T).float()
    assert (lowered - exact).norm() > 2 * (bf16 - exact).norm()


def test_served_reference_rounds_to_bf16():
    """The bf16-as-served encode returns bf16 values, a bf16-sized step from the float32 encode."""
    cpu = torch.device("cpu")
    config = _config("whisper-large-v3") | TINY["whisper"]
    weights = {name: w.to(torch.bfloat16).float() for name, w in whisper.draw_weights(config, 11, cpu).items()}
    mel = torch.randn(2, whisper.MEL_FRAMES, 80)
    with torch.no_grad():
        served = whisper.encode(mel, weights, config, served=True)
        exact = whisper.encode(mel, weights, config)
    assert torch.equal(served, served.to(torch.bfloat16).float())
    assert 1e-4 < ((served - exact).norm() / exact.norm()).item() < 5e-2
