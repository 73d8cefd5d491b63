"""The one general traffic generator: a corpus of WAV files and the order of the calls.

A traffic mix (``traffic/<name>.json``) gives the corpus's size, sample rate and length
law, and how many files a call takes. Every seed gets the same set of lengths (the law's
quantiles at (i + 0.5) / n), so every seed asks the same work; the seed draws which file
has which length, the audio, and the call order. The audio is a tone with a slow
amplitude swell and noise in its troughs, drawn by a ``torch.Generator`` on the device
in a few large calls, written as 16-bit PCM.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np
import torch


@dataclass(frozen=True)
class Corpus:
    """The files of one run: paths, lengths in samples and seconds, in the order they are called."""

    paths: list[Path]
    samples: list[int]
    sample_rate: int

    def seconds(self, index: int) -> float:
        return self.samples[index] / self.sample_rate


def plan_seconds(law: dict, count: int) -> list[float]:
    """The corpus's lengths in seconds: the law's quantiles at (i + 0.5) / count."""
    quantiles = [(i + 0.5) / count for i in range(count)]
    if law["law"] == "log_uniform":
        lo, hi = math.log(law["min_s"]), math.log(law["max_s"])
        return [math.exp(lo + q * (hi - lo)) for q in quantiles]
    if law["law"] == "log_normal":
        normal = NormalDist()
        return [min(law["max_s"], max(law["min_s"], law["median_s"] * math.exp(law["sigma"] * normal.inv_cdf(q))))
                for q in quantiles]
    raise ValueError(f"unknown length law {law['law']!r}")


def wav_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    """A mono 16-bit PCM WAV file of ``pcm`` (int16)."""
    payload = pcm.astype("<i2").tobytes()
    fmt = struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, sample_rate, 2 * sample_rate, 2, 16)
    return b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE" + fmt + b"data" + struct.pack("<I", len(payload)) + payload


def synthesize(samples: list[int], sample_rate: int, seed: int, device: torch.device) -> list[np.ndarray]:
    """int16 audio for each length, drawn from ``seed`` on ``device``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    n = len(samples)
    params = torch.rand((n, 4), generator=generator, device=device, dtype=torch.float64)
    tone_hz, swell_s, phase, noise = 120 + 280 * params[:, 0], 3 + 6 * params[:, 1], params[:, 2], 0.2 + 0.4 * params[:, 3]
    sizes = torch.tensor(samples, device=device)
    owner = torch.repeat_interleave(torch.arange(n, device=device), sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    t = (torch.arange(owner.numel(), device=device) - starts[owner]).double() / sample_rate
    swell = 0.5 + 0.5 * torch.sin(2 * math.pi * (t / swell_s[owner] + phase[owner]))
    wave = swell * torch.sin(2 * math.pi * tone_hz[owner] * t)
    wave = wave + (1 - swell) * noise[owner] * torch.randn(owner.numel(), generator=generator, device=device,
                                                             dtype=torch.float64)
    pieces = []
    for piece in torch.split(wave, samples):
        pieces.append(torch.round(piece * (0.8 * 32767 / piece.abs().max())).to(torch.int16))
    return [p.cpu().numpy() for p in pieces]


def build(traffic: dict, seed: int, directory: Path, device: torch.device) -> Corpus:
    """Writes the mix's corpus for ``seed`` into ``directory``, in call order."""
    spec = traffic["corpus"]
    rate, count = spec["sample_rate"], spec["files"]
    lengths = [int(round(s * rate)) for s in plan_seconds(spec["lengths"], count)]
    order = np.random.default_rng(seed).permutation(count)
    lengths = [lengths[i] for i in order]
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for index, pcm in enumerate(synthesize(lengths, rate, seed, device)):
        path = directory / f"clip_{index:04d}.wav"
        path.write_bytes(wav_bytes(pcm, rate))
        paths.append(path)
    return Corpus(paths, lengths, rate)


def calls(corpus: Corpus, per_call: int):
    """File indices of each call, forever: consecutive slices of the corpus, cycling."""
    n = len(corpus.paths)
    cursor = 0
    while True:
        yield [(cursor + i) % n for i in range(per_call)]
        cursor = (cursor + per_call) % n
