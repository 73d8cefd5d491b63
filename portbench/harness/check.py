"""Whether the timed path's answers are correct: a sample of them against the plain reference.

After the window, a sample of the answers it produced (drawn from the seed, the longest
file's always in it) is held to the reference's answers for the same files:

- ``prob_gap``: the largest gap, over the sampled frames and labels, between the
  program's probability and the reference's;
- ``logit_rel``: the relative L2 gap of the sampled frames' centred log-probabilities
  (the head's logits up to a constant);
- ``frames_off``: answers of the whole window whose frame grid (count, start and end
  seconds to 1 us) is not the reference's for the file's length;
- ``segments_off``: sampled answers whose segments are not what the system's
  postprocessing rules make of the program's own frames;
- ``failed``: files that failed anywhere in the window.

Each number a cell's limits (``limits/<cell>.json``) name is compared and printed beside its
limit: a cell compares the numbers whose control reading sets an upper end for them
(``PERF.md``); ``prob_gap`` and ``logit_rel`` are reported in every run.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.harness.yardstick import resampled_length
from portbench.reference import postprocess
from portbench.reference.answer import expected_grid


def frames_of(result) -> list[dict]:
    return [{"start": f.start_seconds, "end": f.end_seconds, "emotion": f.emotion, "confidence": f.confidence,
             "probabilities": dict(f.probabilities)} for f in result.frames]


def segments_of(result) -> list[dict]:
    return [{"start": s.start_seconds, "end": s.end_seconds, "emotion": s.emotion, "confidence": s.confidence,
             "probabilities": dict(s.probabilities or {})} for s in result.segments]


def sample(records, samples: list[int], count: int, seed: int) -> list[tuple[int, object]]:
    """(file index, result) of ``count`` answers of the window, the longest file's last among them."""
    answers = [(f, r) for record in records for f, r in zip(record.files, record.results) if r is not None]
    if not answers:
        return []
    longest = max(range(len(answers)), key=lambda i: (samples[answers[i][0]], i))
    rest = [i for i in range(len(answers)) if i != longest]
    chosen = np.random.default_rng(seed).choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [answers[longest]] + [answers[rest[i]] for i in sorted(chosen)]


def _grid_matches(frames: list[dict], starts: np.ndarray, ends: np.ndarray) -> bool:
    return len(frames) == len(starts) and bool(
        np.abs(np.array([f["start"] for f in frames]) - starts).max() <= 1e-6
        and np.abs(np.array([f["end"] for f in frames]) - ends).max() <= 1e-6)


def grid_off(records, files, config: dict) -> int:
    """Answers of the window whose frame grid is not the one the file's length makes."""
    grids, off = {}, 0
    for record in records:
        for index, result in zip(record.files, record.results):
            if result is None:
                continue
            if index not in grids:
                grids[index] = expected_grid(resampled_length(files.samples[index], files.sample_rate), config)
            off += not _grid_matches(frames_of(result), *grids[index])
    return off


def _segments_equal(a: list[dict], b: list[dict]) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x["emotion"], x["start"], x["end"]) != (y["emotion"], y["start"], y["end"]):
            return False
        if not math.isclose(x["confidence"], y["confidence"], rel_tol=1e-12, abs_tol=1e-15):
            return False
        if x["probabilities"].keys() != y["probabilities"].keys() or any(
                not math.isclose(x["probabilities"][k], y["probabilities"][k], rel_tol=1e-12, abs_tol=1e-15)
                for k in x["probabilities"]):
            return False
    return True


def judge(got: list[tuple[int, list[dict], list[dict]]], reference: dict[int, object], runtime: dict,
          labels: list[str], failed: int, frames_off: int) -> dict[str, float]:
    """The compared numbers for the sampled answers ``got`` ((file index, frames, segments) each)
    against ``reference`` (file index → Answer), with the window's ``failed`` and ``frames_off``.
    A missing label reads as a gap of 1; an answer off the grid is compared no further."""
    prob_gap, segments_off = 0.0, 0
    logit_sq = logit_ref_sq = 0.0
    for index, frames, segments in got:
        expected = reference[index]
        if not _grid_matches(frames, expected.starts, expected.ends):
            continue
        values = np.array([[f["probabilities"].get(label, math.nan) for label in labels] for f in frames])
        prob_gap = max(prob_gap, float(np.nan_to_num(np.abs(values - expected.probabilities), nan=1.0).max()))
        centered = np.log(np.clip(np.nan_to_num(values, nan=1e-300), 1e-300, None))
        centered -= centered.mean(axis=1, keepdims=True)
        truth = np.log(expected.probabilities)
        truth -= truth.mean(axis=1, keepdims=True)
        logit_sq += float(((centered - truth) ** 2).sum())
        logit_ref_sq += float((truth**2).sum())
        if not _segments_equal(segments, postprocess.segments(frames, runtime)):
            segments_off += 1
    return {"prob_gap": prob_gap, "logit_rel": math.sqrt(logit_sq / logit_ref_sq) if logit_ref_sq > 0 else 0.0,
            "frames_off": frames_off, "segments_off": segments_off, "failed": failed, "answers": len(got)}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers; no answer compared is not correct."""
    shown = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    correct = numbers["answers"] > 0 and all(numbers[name] <= limit for name, limit in limits.items())
    return correct, shown
