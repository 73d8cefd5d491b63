"""The traffic generator: deterministic per seed, the same work for every seed."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.harness import corpus
from portbench.reference import audio


def test_plan_quantiles():
    seconds = corpus.plan_seconds({"law": "log_uniform", "min_s": 60, "max_s": 600}, 16)
    assert min(seconds) > 60 and max(seconds) < 600 and seconds == sorted(seconds)
    assert np.mean(corpus.plan_seconds({"law": "log_uniform", "min_s": 60, "max_s": 600}, 4096)) == \
        pytest.approx(540 / math.log(10), rel=1e-3)
    clipped = corpus.plan_seconds({"law": "log_normal", "median_s": 4.0, "sigma": 0.5, "min_s": 1, "max_s": 15}, 256)
    assert np.median(clipped) == pytest.approx(4.0, rel=0.01) and 1 <= min(clipped) and max(clipped) <= 15


def _build(seed, tmp_path, name):
    traffic = {"corpus": {"files": 5, "sample_rate": 48000,
                          "lengths": {"law": "log_uniform", "min_s": 0.5, "max_s": 3.0}}}
    return corpus.build(traffic, seed, tmp_path / name, torch.device("cpu"))


def test_same_seed_same_files_other_seed_same_lengths(tmp_path):
    a, b, c = _build(2**40 + 3, tmp_path, "a"), _build(2**40 + 3, tmp_path, "b"), _build(7, tmp_path, "c")
    assert a.samples == b.samples and sorted(a.samples) == sorted(c.samples) and a.samples != c.samples
    for x, y in zip(a.paths, b.paths):
        assert x.read_bytes() == y.read_bytes()
    assert a.paths[0].read_bytes() != c.paths[c.samples.index(a.samples[0])].read_bytes()


def test_wav_round_trip(tmp_path):
    built = _build(11, tmp_path, "w")
    samples, rate = audio.read_wav(built.paths[0])
    assert rate == 48000 and samples.size == built.samples[0] and np.abs(samples).max() == pytest.approx(1.0)


def test_calls_cycle():
    files = corpus.Corpus(paths=[None] * 5, samples=[1] * 5, sample_rate=16000)
    plan = corpus.calls(files, 2)
    assert [next(plan) for _ in range(3)] == [[0, 1], [2, 3], [4, 0]]
