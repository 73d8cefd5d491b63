"""On the card, at each cell's own size: the program comes out correct and its control does not.

The control is the configuration's lower precision (``control`` in its file): the port's own
int8 lane for Whisper, the reference with int8 products in the program's place for
wav2vec2. Skips without a card; on the card's machine:
``python -m pytest portbench/tests/test_chip.py -q`` (about 6 minutes).
"""

from __future__ import annotations

import time

import pytest

from portbench.harness import runner, spec

CONTROL_SEEDS = (2**33 + 101, 2**33 + 102, 2**33 + 103)


def _cells():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", _cells())
def test_program_correct_and_control_not(card, benchmark, name):
    cell = spec.load_cell(benchmark, name)
    result, _, readings = runner.run(cell, 2**33 + 100, 2.0, False, started=time.perf_counter(), benchmark=benchmark)
    assert result["correct"], readings
    for seed in CONTROL_SEEDS:
        result, _, readings = runner.run(cell, seed, 2.0, False, started=time.perf_counter(), control=True,
                                         benchmark=benchmark)
        assert not result["correct"], (seed, readings)
