"""Plain reference of one file's answer: frame probabilities, from the WAV file on.

Read and resample (``audio``), encode (``whisper`` or ``wav2vec2``), then pool: windows of
``pool_window_size_seconds`` every ``pool_window_stride_seconds`` over the frames' span (one
window when the clip is no longer than that; a last window ending at the clip's end where
the stride leaves it short), each the mean and population standard deviation of the frames
it overlaps, in float64. The MLP head (ReLU, then softmax) in float64 gives each window's
probabilities.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import audio, wav2vec2, whisper


@dataclass(frozen=True)
class Answer:
    """One file's frames: start and end seconds (F,) and probabilities (F, labels)."""

    starts: np.ndarray
    ends: np.ndarray
    probabilities: np.ndarray


def pooling_windows(first: float, last: float, size: float, stride: float) -> list[tuple[float, float]]:
    """(start, end) of each pooling window over [first, last]."""
    span = last - first
    size = min(size, span)
    if np.isclose(size, span):
        return [(first, last)]
    windows, cursor = [], first
    while cursor + size <= last + 1e-9:
        windows.append((cursor, min(last, cursor + size)))
        cursor += stride
    if not windows:
        return [(max(first, last - size), last)]
    if windows[-1][1] < last - 1e-9:
        tail = max(first, last - size)
        if not (np.isclose(windows[-1][0], tail) and np.isclose(windows[-1][1], last)):
            windows.append((tail, last))
    return windows


def pool(states: np.ndarray, starts: np.ndarray, ends: np.ndarray, windows) -> np.ndarray:
    """(W, 2·d) float64: the mean and standard deviation of the frames each window overlaps."""
    rows = []
    for lo, hi in windows:
        chosen = states[(ends > lo) & (starts < hi)].astype(np.float64)
        rows.append(np.concatenate([chosen.mean(axis=0), chosen.std(axis=0)]))
    return np.stack(rows)


def head_probabilities(features: np.ndarray, head: dict) -> np.ndarray:
    """Softmax of the ReLU MLP's logits, float64."""
    x = features
    for weight, bias in list(zip(head["weights"], head["biases"]))[:-1]:
        x = np.maximum(x @ weight.astype(np.float64) + bias, 0.0)
    logits = x @ head["weights"][-1].astype(np.float64) + head["biases"][-1]
    exp = np.exp(logits - logits.max(axis=1, keepdims=True))
    return exp / exp.sum(axis=1, keepdims=True)


def encoder_weights(config: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """The encoder's weights, drawn as the port's seeded init draws them, as float32 tensors.

    With the configuration's ``reference: {"weights": "bfloat16"}`` each is first rounded to
    bf16: the values of the model as it is served.
    """
    seed = whisper.init_seed(config["backend_id"], config["model_id"])
    model = wav2vec2 if config["family"] == "wav2vec2" else whisper
    weights = model.draw_weights(config, seed, device)
    if config.get("reference", {}).get("weights") == "bfloat16":
        weights = {name: w.to(torch.bfloat16).float() for name, w in weights.items()}
    return weights


def expected_grid(samples16k: int, config: dict) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the pooling windows of a clip of ``samples16k`` samples at 16 kHz: the
    frame grid every answer for it must have."""
    if config["family"] == "wav2vec2":
        starts, ends = wav2vec2.frame_times(samples16k, config)
    else:
        starts, ends = whisper.frame_times(samples16k)
    runtime = config["runtime"]
    windows = pooling_windows(float(starts[0]), float(ends[-1]), runtime["pool_window_size_seconds"],
                              runtime["pool_window_stride_seconds"])
    return np.array([w[0] for w in windows]), np.array([w[1] for w in windows])


def answer(path, config: dict, weights: dict[str, torch.Tensor], head: dict, device: torch.device,
           product=None) -> Answer:
    """The reference's frames for one WAV file."""
    samples, rate = audio.read_wav(path)
    samples16k = audio.to_16k(samples, rate)
    model = wav2vec2 if config["family"] == "wav2vec2" else whisper
    extra = {} if product is None else {"product": product}
    states, starts, ends = model.frame_states(samples16k, weights, config, device, **extra)
    runtime = config["runtime"]
    windows = pooling_windows(float(starts[0]), float(ends[-1]), runtime["pool_window_size_seconds"],
                              runtime["pool_window_stride_seconds"])
    probabilities = head_probabilities(pool(states, starts, ends, windows), head)
    return Answer(np.array([w[0] for w in windows]), np.array([w[1] for w in windows]), probabilities)
