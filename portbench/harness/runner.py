"""One run of one cell: set-up, the measured window, the readers, the check, the result line.

The program's output (and anything else written to standard output) goes to standard
error; the result is the last line of standard output. The check's numbers, each beside
its limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from portbench.harness import check, corpus, program, spec
from portbench.harness.driving import run_window
from portbench.harness.readings import Context

HOST_PROBE_OPS = 20000
#: A traced window runs whole cycles for at least this long (or ``--seconds``, if shorter):
#: the profiler's events of a longer one take minutes to read.
TRACED_SECONDS = 10.0


def parse(argv: list[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true",
                        help="run the configuration's control (lower precision) instead of the program's answers")
    return parser.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        out = f"nvidia-smi unavailable: {err}"
    return out or "nvidia-smi read nothing"


def host_us_per_op(device) -> float:
    """Host microseconds per PyTorch op: a loop of 1-element adds that the card outpaces."""
    import torch

    x = torch.zeros(1, device=device)
    synchronize(device)
    started = time.perf_counter()
    for _ in range(HOST_PROBE_OPS):
        x.add_(1)
    synchronize(device)
    return (time.perf_counter() - started) / HOST_PROBE_OPS * 1e6


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_frames(answer, labels: list[str]) -> list[dict]:
    """A reference answer shaped as the program's frames (label: the most probable)."""
    return [{"start": float(s), "end": float(e), "emotion": labels[int(p.argmax())], "confidence": float(p.max()),
             "probabilities": {label: float(v) for label, v in zip(labels, p)}}
            for s, e, p in zip(answer.starts, answer.ends, answer.probabilities)]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, started: float, device: str = "cuda",
        control: bool = False, benchmark: dict | None = None,
        variants: dict[str, dict] | None = None) -> tuple[dict, list[str], dict]:
    """One run; (result line, check lines, readings). ``variants`` (calibration) names further
    configuration overrides under which the same answers are judged again."""
    import torch

    from portbench.reference.head import draw_head

    benchmark = benchmark if benchmark is not None else spec.load_benchmark()
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    control_spec = config["control"] if control else {}
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    readings: dict[str, dict] = {}
    try:
        say("card", card_line())
        files = corpus.build(traffic, seed, work / "corpus", dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        width = config["hidden_size"] if config["family"] == "wav2vec2" else config["d_model"]
        head = draw_head(seed, 2 * width, config["head_hidden"], config["labels"])
        settings = program.prepare(config, work, device, head, control_spec.get("program_env"))
        driver = spec.load_module("drivers", traffic["entry"]).Driver(settings, config, files, traffic)
        say("host us_per_op", [round(host_us_per_op(dev), 3) for _ in range(3)])
        plan = corpus.calls(files, driver.per_call)
        cycle = -(-len(files.paths) // driver.per_call)
        warm = [driver.call(next(plan)) for _ in range(cycle)]
        warm_failed = [r.error for r in warm if r.error]
        if warm_failed:
            say("warm-up failures", warm_failed[:3])
        synchronize(dev)
        setup_s = time.perf_counter() - started
        plan = corpus.calls(files, driver.per_call)
        peak, setup_peak = None, 0
        if dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if trace:
            from portbench.harness.trace import DeviceTrace

            with DeviceTrace() as traced:
                records, window_s = run_window(driver, plan, min(seconds, TRACED_SECONDS), cycle,
                                               lambda: synchronize(dev))
            summary = traced.summary()
        else:
            records, window_s = run_window(driver, plan, seconds, cycle, lambda: synchronize(dev))
            summary = None
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated()
        memory_peak = max(setup_peak, peak or 0)
        ctx = Context(config, traffic, files, records, window_s, setup_s, peak, summary)
        metrics = {}
        for entry in spec.metrics_for(benchmark, cell.name, trace):
            value = spec.load_module("metrics", entry["name"]).read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        attempted = sum(len(r.files) for r in records)
        failed = sum(result is None for r in records for result in r.results)
        say("calls", len(records), "attempted", attempted, "failed", failed, "window_s", window_s)
        say("call seconds", [round(r.latency, 3) for r in records])
        for r in records:
            if r.error:
                say("call error", r.error[:500])
        del driver
        program.release()
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        sampled = check.sample(records, files.samples, traffic["check"]["answers"], seed)
        off = check.grid_off(records, files, config)
        numbers = check_readings(sampled, files, config, head, dev, control_spec, failed, off)
        for name, overrides in (variants or {}).items():
            readings[name] = check_readings(sampled, files, config | overrides, head, dev,
                                            control_spec | overrides.get("control", {}), failed, off)
        say("check readings", json.dumps(numbers))
        correct, shown = check.verdict(numbers, cell.limits)
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                       "count": cell.chips, "memory_peak_bytes": memory_peak}
        if summary is not None:
            device_info |= {"busy_s": summary.busy_s, "window_s": summary.window_s}
        result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
                  "device": device_info}
        if summary is not None:
            result["breakdown"] = summary.breakdown()
        result["check"] = shown
        lines = [f"check {name} {v['value']!r} limit {v['limit']!r}" for name, v in shown.items()]
        readings["primary"] = numbers
        return result, lines, readings
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_readings(sampled, files, config: dict, head: dict, dev, control_spec: dict, failed: int,
                   frames_off: int) -> dict:
    """The sampled answers judged against the reference (the control's in place of the program's
    when ``control_spec`` names a lower-precision product for the reference)."""
    from portbench.reference import answer as ref
    from portbench.reference import postprocess, precision

    weights = ref.encoder_weights(config, dev)
    indices = sorted({i for i, _ in sampled})
    reference = {i: ref.answer(files.paths[i], config, weights, head, dev) for i in indices}
    product = control_spec.get("reference_product")
    if product:
        lowered = {i: ref.answer(files.paths[i], config, weights, head, dev, getattr(precision, f"{product}_linear"))
                   for i in indices}
        frames = {i: reference_frames(a, config["labels"]) for i, a in lowered.items()}
        got = [(i, frames[i], postprocess.segments(frames[i], config["runtime"])) for i, _ in sampled]
    else:
        got = [(i, check.frames_of(result), check.segments_of(result)) for i, result in sampled]
    del weights
    return check.judge(got, reference, config["runtime"], config["labels"], failed, frames_off)


def main(argv: list[str], started: float) -> int:
    args = parse(argv)
    if not (spec.ROOT / "ser_tpu_torch" / "__init__.py").is_file():
        say(f"the program under test, ser_tpu_torch, is not in this checkout ({spec.ROOT})")
        return 2
    benchmark = spec.load_benchmark()
    cell = spec.load_cell(benchmark, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    saved_stdout = os.dup(1)
    os.dup2(2, 1)
    result, lines, _ = run(cell, args.seed, args.seconds, bool(args.trace), started=started, control=args.control,
                        benchmark=benchmark)
    loaded = program.forbidden_loaded()
    if loaded:
        say("forbidden modules loaded in this process:", ", ".join(loaded))
        return 3
    for line in lines:
        say(line)
    sys.stdout.flush()
    os.write(saved_stdout, (json.dumps(result, allow_nan=False, default=_plain) + "\n").encode())
    return 0


def _plain(value):
    """numpy scalars as Python numbers."""
    return value.item()
