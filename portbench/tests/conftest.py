"""Fixtures of the benchmark's own tests: tiny cells on the CPU, and the card for those marked ``chip``.

Run from the repository root: ``python -m pytest portbench/tests -q`` (the ``chip`` tests skip
without a CUDA card; on the card's machine they run the control at the cells' own sizes).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import spec  # noqa: E402

#: The port's tiny random-init widths (``WhisperConfig.tiny``, ``Wav2Vec2Config.tiny``), and a
#: reference wholly in float32, as the port computes on the CPU.
TINY = {
    "whisper": {"reference": {}, "random_init_size": "tiny", "num_mel_bins": 80, "d_model": 64, "encoder_layers": 2,
                "encoder_attention_heads": 4, "encoder_ffn_dim": 256},
    "wav2vec2": {"reference": {}, "random_init_size": "tiny", "hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "intermediate_size": 128, "conv_dim": [32] * 7, "num_conv_pos_embeddings": 16,
                 "num_conv_pos_embedding_groups": 4},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def benchmark():
    """``BENCHMARK.json`` with the entries of the cells kept for later (``pending/``), so that
    their drivers and readers are tested too."""
    loaded = spec.load_benchmark()
    for path in sorted((spec.BENCH_DIR / "pending").glob("*.json")):
        entries = json.loads(path.read_text(encoding="utf-8"))
        for section in ("workloads", "end_to_end", "per_layer"):
            loaded[section] = loaded[section] + entries[section]
    return loaded


@pytest.fixture
def tiny_cell(benchmark, monkeypatch, tmp_path):
    """A cell of ``BENCHMARK.json`` at the port's tiny widths, with a corpus of a few short files."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)

    def make(name: str, files: int = 3, max_s: float = 6.0) -> spec.Cell:
        cell = spec.load_cell(benchmark, name)
        config = copy.deepcopy(cell.config) | TINY[cell.config["family"]]
        traffic = copy.deepcopy(cell.traffic)
        traffic["corpus"]["files"] = files
        lengths = traffic["corpus"]["lengths"]
        lengths.update({"min_s": 1.0, "max_s": max_s} if lengths["law"] == "log_uniform" else {"max_s": max_s})
        traffic["call_files"] = min(traffic["call_files"], 2)
        traffic["check"]["answers"] = 2
        return dataclasses.replace(cell, config=config, traffic=traffic)

    return make
