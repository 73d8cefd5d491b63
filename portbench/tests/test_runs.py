"""Whole runs of tiny cells on the CPU, each driver to its result; the command's refusals."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness import runner, spec


def _run(cell, **kwargs):
    return runner.run(cell, 2**35 + 17, 0.5, kwargs.pop("trace", False), started=time.perf_counter(),
                      device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["large-v3.long-files", "xlsr-300m.mixed-files", "large-v3.requests"])
def test_tiny_run_is_correct(tiny_cell, benchmark, name):
    result, lines, readings = _run(tiny_cell(name), benchmark=benchmark)
    assert result["correct"], readings
    assert list(result)[-1] == "check" and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_for(benchmark, name, trace=False)}
    assert [line.split()[1] for line in lines] == list(result["check"])
    json.dumps(result, allow_nan=False, default=runner._plain)


def test_tiny_traced_run_reads_host_spans(tiny_cell, benchmark):
    result, _, _ = _run(tiny_cell("large-v3.requests"), benchmark=benchmark, trace=True)
    assert result["correct"]
    assert result["metrics"]["emotion_inference_s.request"]["value"] > 0
    assert "device_idle.request" not in result["metrics"]  # no device activity on the CPU: nothing to read
    assert result["device"]["busy_s"] == 0.0 and "breakdown" in result


def test_control_reads_farther_than_the_program(tiny_cell, benchmark):
    cell = tiny_cell("xlsr-300m.mixed-files")
    _, _, sound = _run(cell, benchmark=benchmark)
    _, _, control = _run(cell, benchmark=benchmark, control=True)
    assert control["primary"]["logit_rel"] > 10 * sound["primary"]["logit_rel"]


def test_command_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "large-v3.long-files", "--seed",
                           str(2**40), "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "large-v3.long-files", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == "" and "not in this checkout" in done.stderr
