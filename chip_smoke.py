#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one CUDA card and checks its kernels.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ser_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel), then, one phase per line:

1. environment: torch/CUDA versions, the card's name and power limit, build time;
2. K1 (power → mel → log10) at the main path's shapes, against its plain
   version on the same inputs, with its time, the plain version's and its bound;
3. K2 (flash attention) at the encoder's shapes, with and without a key mask,
   against its plain version in float32, with SDPA's time as the yardstick;
4. the large-v3 encoder at full width (32 layers, seeded random weights, bf16)
   on 8 windows: audio-seconds per second, MFU, launches per encode, and a
   2-layer full-width card-vs-CPU check of the same weights;
5. ``ser_tpu_torch.api.infer(profile="accurate")`` on three synthetic clips at
   full width, with every kernel's launch count set to 0 just before and read
   just after.

It prints a ``kernels`` JSON line, the card's name and power limit, and, as
its last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line, as does a machine with no CUDA device or a directory
without the port.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Data-sheet peaks of one H100 SXM (dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# K1, max abs error of the raw log10-mel: float32 sums in another order (the
# JAX package's pin).
K1_TOLERANCE = 5e-5
# K2, relative L2 error against the float32 plain version on the same bf16
# q, k, v. With randn inputs over 1500 keys the outputs are small (rms 0.043,
# max 0.73 on an H100), so an absolute limit says little. The kernel's own error
# is bf16 rounding of P before the P·V product and of the output, each about
# 2^-9 of an element: 0.0022 measured, masked or not, and the limit is about 3x
# that. Phase K2 also checks that the limit catches a kernel that lets the 36
# keys past T in the last 64-key tile into the softmax as zeros.
K2_REL_L2_TOLERANCE = 7e-3
# Full-width encoder, 2 layers: bf16 weights and activations on the card
# against float32 on the CPU, same weights (about 3.6x the measured 0.00562).
ENCODER_REL_L2_BOUND = 2e-2

RAVDESS_LABELS = ["angry", "calm", "disgust", "fearful", "happy", "neutral", "sad", "surprised"]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{key}={value}" for key, value in fields.items()), flush=True)


def cuda_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(*, bytes_moved: float, flops: float, peak_flops: float) -> tuple[float, str]:
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def nvidia_smi_line() -> str:
    completed = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return completed.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #


def phase_environment() -> dict:
    import torch

    from ser_tpu_torch.ops import kernel_build

    smi = nvidia_smi_line()
    say("env", torch=torch.__version__, cuda=torch.version.cuda, card=json.dumps(smi),
        count=torch.cuda.device_count())
    started = time.perf_counter()
    libraries = kernel_build.build_all()
    say("build", seconds=f"{time.perf_counter() - started:.1f}", libraries=len(libraries))
    for name in libraries:
        for line in kernel_build.ptxas_report(name).splitlines():
            say("ptxas", source=f"{name}.cu", info=json.dumps(line.strip()))
    return {"smi": smi}


def phase_k1() -> dict:
    import torch

    from ser_tpu_torch.ops import log_mel

    torch.manual_seed(0)
    batch, samples, n_mels = 8, 30 * 16000, 128
    wave = 0.1 * torch.randn(batch, samples, device="cuda")
    log_mel.set_strict_float32()
    spec = log_mel.stft(wave, 400, 160).contiguous()  # (8, 3001, 402)
    fb = torch.from_numpy(log_mel._mel_fb_t(16000, 400, n_mels)).cuda()
    out_frames = 3000
    kernel_out = log_mel.power_mel_log(spec, fb, out_frames)
    plain_out = log_mel.power_mel_log_reference(spec, fb, out_frames)
    torch.cuda.synchronize()
    err = (kernel_out - plain_out).abs().max().item()
    ms = cuda_ms(lambda: log_mel.power_mel_log(spec, fb, out_frames))
    plain_ms = cuda_ms(lambda: log_mel.power_mel_log_reference(spec, fb, out_frames))
    n_bins = fb.shape[0]
    bytes_moved = spec.numel() * 4 + fb.numel() * 4 + batch * out_frames * n_mels * 4
    # Power, the projection over the filterbank's non-zero weights, and the log.
    nonzero = int((fb != 0).sum().item())
    flops = batch * out_frames * (3 * n_bins + 2 * nonzero + n_mels)
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_F32_FLOPS)
    say("K1", shape=f"spec{tuple(spec.shape)}->out{tuple(kernel_out.shape)}", max_abs_err=err,
        tolerance=K1_TOLERANCE, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, mbytes=f"{bytes_moved / 1e6:.1f}", gflop=f"{flops / 1e9:.3f}")
    if not err <= K1_TOLERANCE:
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {K1_TOLERANCE}")
    return {
        "name": "power_mel_log",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/log_mel.cu",
        "replaces": "ser_tpu/ops/pallas_kernels.py:93",
        "max_abs_err": err,
        "tolerance": K1_TOLERANCE,
        "tolerance_on": "max_abs_err",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_k2() -> dict:
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.models import attention

    torch.manual_seed(1)
    batch, seq, heads, dim = 8, 1500, 20, 64
    q, k, v = (torch.randn(batch, seq, heads, dim, device="cuda").to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor([seq - 97 * i for i in range(batch)], device="cuda")
    mask = torch.arange(seq, device="cuda")[None, :] < lengths[:, None]

    results = {}
    for label, frame_mask in (("unmasked", None), ("masked", mask)):
        out = attention.flash_attention(q, k, v, frame_mask=frame_mask)
        ref = attention.attention_reference(q.float(), k.float(), v.float(), frame_mask=frame_mask)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        rel_l2 = ((out.float() - ref).norm() / ref.norm()).item()
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, frame_mask=frame_mask))
        ref_size = f"rms={ref.pow(2).mean().sqrt().item():.4f},max={ref.abs().max().item():.4f}"
        results[label] = (err, rel_l2, ms, ref_size)
        if not rel_l2 <= K2_REL_L2_TOLERANCE:
            raise AssertionError(
                f"K2 ({label}) disagrees with its plain version: rel L2 {rel_l2} > {K2_REL_L2_TOLERANCE}"
            )
        if frame_mask is None:
            # What a kernel that forgot to mask the last tile's keys past T would give.
            tail = torch.zeros(batch, -seq % 64, heads, dim, device="cuda")
            leaky = attention.attention_reference(
                q.float(), torch.cat([k.float(), tail], 1), torch.cat([v.float(), tail], 1)
            )
            tail_leak_rel_l2 = ((leaky - ref).norm() / ref.norm()).item()
            if not tail_leak_rel_l2 > K2_REL_L2_TOLERANCE:
                raise AssertionError(f"K2's limit would pass unmasked tail keys: {tail_leak_rel_l2}")
            del leaky
    plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v), iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4.0 * batch * heads * seq * seq * dim
    bytes_moved = 4 * q.numel() * 2
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
    err, rel_l2, ms, ref_size = results["unmasked"]
    masked_err, masked_rel_l2, masked_ms, _ = results["masked"]
    say("K2", shape=f"(B,T,H,D)=({batch},{seq},{heads},{dim}) bf16", max_abs_err=err,
        rel_l2_err=rel_l2, masked_max_abs_err=masked_err, masked_rel_l2_err=masked_rel_l2,
        rel_l2_tolerance=K2_REL_L2_TOLERANCE, tail_leak_rel_l2=tail_leak_rel_l2, ref_abs=ref_size,
        ms=f"{ms:.4f}", masked_ms=f"{masked_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
        tflops=f"{flops / ms / 1e9:.1f}")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ser_tpu/models/attention.py:117",
        "max_abs_err": err,
        "rel_l2_err": rel_l2,
        "masked_max_abs_err": masked_err,
        "masked_rel_l2_err": masked_rel_l2,
        "tolerance": K2_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "masked_ms": masked_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _encoder_flops(config, n_windows: int) -> float:
    """2·MACs of the conv stem and the per-layer matmuls at 1500 states (bench.py's count)."""
    t_mel, t = 3000, 1500
    d, layers, ffn = config.d_model, config.encoder_layers, 4 * config.d_model
    macs_conv = t_mel * 3 * config.n_mels * d + t * 3 * d * d
    macs_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * ffn
    return 2.0 * (macs_conv + layers * macs_layer) * n_windows


_KERNEL_GROUPS = (
    ("K2 flash_attention", ("flash_attention_fwd_kernel",)),
    ("K1 power_mel_log", ("power_mel_log_kernel",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("conv", ("cudnn", "conv")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel", "copy", "Memset", "Memcpy")),
)


def _kernel_group(name: str) -> str:
    for group, needles in _KERNEL_GROUPS:
        if any(needle in name for needle in needles):
            return group
    return "other"


def _profile_encode(encode) -> str:
    """Device time of one encode by kernel group, and the device's busy share.

    The profiler runs one warm-up step first, so the profiled step's wall
    time holds no profiler start-up. Only device events (kernels, memsets,
    copies) are summed. Informational: where the profiler cannot trace the
    card, it says so and the run goes on (the phase's numbers come from the
    host clock and CUDA events).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = {}
    try:
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: traced.setdefault("events", p.key_averages()),
        ) as prof:
            encode()
            torch.cuda.synchronize()
            prof.step()
            started = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - started) * 1e3
            prof.step()
    except RuntimeError as err:
        return f"unavailable ({err})"
    events = traced.get("events", [])
    # Device events (kernels, memsets, copies) take no host time of their own;
    # an operator's row repeats the device time of the kernels it launched, and
    # the step's own row ("ProfilerStep*") spans all of them.
    kernels = [
        e
        for e in events
        if e.self_cpu_time_total == 0 and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")
    ]
    if not kernels:
        return "unavailable (no device events traced)"
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict[str, float] = {}
    for event in kernels:
        group = _kernel_group(event.key)
        groups[group] = groups.get(group, 0.0) + event.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    rows = [[e.key[:72], e.count, round(e.self_device_time_total / 1e3, 3)] for e in top]
    say("encoder-kernels", top=json.dumps(rows))
    shares = ", ".join(f"{g}:{ms:.3f}ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    return f"wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} busy={device_ms / wall_ms:.4f} groups=[{shares}]"


def phase_encoder() -> dict:
    import numpy as np
    import torch

    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.ops import log_mel

    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    started = time.perf_counter()
    state = wm.random_whisper_encoder_state(config, seed=0, device=cuda)
    encoder = wm.build_whisper_encoder(config, state, device=cuda, dtype=torch.bfloat16)
    del state
    torch.cuda.synchronize()
    say("encoder-build", seconds=f"{time.perf_counter() - started:.2f}",
        params_m=f"{sum(p.numel() for p in encoder.parameters()) / 1e6:.1f}")

    n_windows, repeats = 8, 3
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy((0.1 * rng.standard_normal((n_windows, wm.CHUNK_SAMPLES))).astype(np.float32)).to(cuda)
    states = wm.encode_mel_chunks(encoder, chunks)  # warm-up
    torch.cuda.synchronize()
    if states.shape != (n_windows, 1500, config.d_model) or not torch.isfinite(states).all():
        raise AssertionError(f"encoder output {tuple(states.shape)} is not finite/of the right shape")

    log_mel.COUNTER.launches = 0
    attention.COUNTER.launches = 0
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    for _ in range(repeats):
        states = wm.encode_mel_chunks(encoder, chunks)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - started
    k1_per, k2_per = log_mel.COUNTER.launches / repeats, attention.COUNTER.launches / repeats
    audio_s_per_s = repeats * n_windows * 30.0 / elapsed
    mfu = _encoder_flops(config, n_windows) * repeats / elapsed / PEAK_BF16_FLOPS
    say("encoder", windows=n_windows, repeats=repeats, seconds=f"{elapsed:.4f}",
        ms_per_encode=f"{elapsed / repeats * 1e3:.2f}", audio_s_per_s=f"{audio_s_per_s:.1f}",
        mfu=f"{mfu:.4f}", k1_per_encode=k1_per, k2_per_encode=k2_per,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if (k1_per, k2_per) != (1, config.encoder_layers):
        raise AssertionError(f"launches per encode K1={k1_per} K2={k2_per}, expected 1 and 32")
    breakdown = _profile_encode(lambda: wm.encode_mel_chunks(encoder, chunks))
    say("encoder-profile", detail=breakdown)
    del encoder, states
    torch.cuda.empty_cache()

    # Card (kernels, bf16) against CPU (plain versions, float32): the same
    # seeded weights at full width, 2 layers, one window.
    small = wm.WhisperConfig(encoder_layers=2)
    cpu_state = wm.random_whisper_encoder_state(small, seed=1, device="cpu")
    on_card = wm.build_whisper_encoder(small, cpu_state, device=cuda, dtype=torch.bfloat16)
    on_cpu = wm.build_whisper_encoder(small, cpu_state, device=torch.device("cpu"), dtype=torch.float32)
    card_out = wm.encode_mel_chunks(on_card, chunks[:1]).cpu()
    cpu_out = wm.encode_mel_chunks(on_cpu, chunks[:1].cpu())
    rel_l2 = ((card_out - cpu_out).norm() / cpu_out.norm()).item()
    say("encoder-check", layers=2, d_model=small.d_model, rel_l2=f"{rel_l2:.5f}",
        bound=ENCODER_REL_L2_BOUND, max_abs=f"{(card_out - cpu_out).abs().max().item():.4f}")
    if not rel_l2 <= ENCODER_REL_L2_BOUND:
        raise AssertionError(f"card encoder disagrees with the CPU: rel L2 {rel_l2} > {ENCODER_REL_L2_BOUND}")
    return {"k1_per_encode": k1_per, "k2_per_encode": k2_per}


def _write_head_envelope(path: Path, feature_size: int) -> None:
    """A ser_tpu v3 artifact envelope holding a seeded ser_tpu_mlp head."""
    import numpy as np

    rng = np.random.default_rng(7)
    dims = [feature_size, 300, len(RAVDESS_LABELS)]
    state = {
        "kind": "ser_tpu_mlp",
        "hidden_layer_sizes": [300],
        "alpha": 0.01,
        "batch_size": 256,
        "epsilon": 1e-8,
        "max_iter": 500,
        "random_state": 42,
        "classes": RAVDESS_LABELS,
        "weights": [
            (rng.standard_normal((a, b)) * math.sqrt(2.0 / (a + b))).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])
        ],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]],
        "n_iter": 1,
        "loss": 1.0,
    }
    metadata = {
        "artifact_version": 3,
        "artifact_schema_version": "v2",
        "feature_vector_size": feature_size,
        "feature_dim": feature_size,
        "training_samples": 1,
        "labels": RAVDESS_LABELS,
        "backend_id": "jax_whisper_encoder",
        "profile": "accurate",
        "pooling_strategy": "mean_std",
        "backend_model_id": "openai/whisper-large-v3",
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(pickle.dumps({"artifact_version": 3, "model": state, "metadata": metadata}))


def _write_clip(path: Path, seconds: float, sample_rate: int, seed: int) -> None:
    import numpy as np

    from ser_tpu_torch._internal.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    audio = mix * np.sin(2 * np.pi * (180 + 40 * seed) * t) + (1 - mix) * 0.4 * rng.standard_normal(t.size)
    write_wav(path, (0.8 * audio / np.abs(audio).max()).astype(np.float32), sample_rate)


def phase_infer() -> dict:
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel

    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        artifact = root / "models" / profile_artifact_file_name(
            profile="accurate", model_id="openai/whisper-large-v3"
        )
        _write_head_envelope(artifact, feature_size=2 * 1280)
        clips = []
        for index, seconds in enumerate((10.0, 45.0, 75.0)):
            clip = root / f"clip_{int(seconds)}s.wav"
            _write_clip(clip, seconds, 48000, seed=index)
            clips.append((clip, seconds))
        os.environ["SER_ALLOW_RANDOM_INIT"] = "1"
        os.environ["SER_RANDOM_INIT_SIZE"] = "full"
        settings = build_settings(
            {
                "SER_ENABLE_ACCURATE_PROFILE": "1",
                "SER_MODELS_FOLDER": str(root / "models"),
                "SER_CACHE_DIR": str(root / "cache"),
            }
        )

        def run(clip: Path):
            started = time.perf_counter()
            execution = api.infer(clip, profile="accurate", include_transcript=False, settings=settings)
            torch.cuda.synchronize()
            return execution, time.perf_counter() - started

        log_mel.COUNTER.launches = 0
        attention.COUNTER.launches = 0
        executions = [run(clip) for clip, _ in clips]
        launches = {"power_mel_log": log_mel.COUNTER.launches, "flash_attention_fwd": attention.COUNTER.launches}
        warm = [run(clip)[1] for clip, _ in clips]

    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        segments = execution.detailed_result.segments
        if execution.backend_id != "jax_whisper_encoder":
            raise AssertionError(f"backend_id {execution.backend_id!r}")
        if not segments or abs(segments[0].start_seconds) > 1e-6 or abs(segments[-1].end_seconds - seconds) > 0.05:
            raise AssertionError(f"segments of {clip.name} do not cover it: {segments[:1]}..{segments[-1:]}")
        for before, after in zip(segments, segments[1:]):
            if abs(after.start_seconds - before.end_seconds) > 1e-6:
                raise AssertionError(f"gap between segments in {clip.name}")
        probabilities = [p for frame in execution.detailed_result.frames for p in frame.probabilities.values()]
        if not all(math.isfinite(p) for p in probabilities):
            raise AssertionError(f"non-finite probabilities for {clip.name}")
        say("infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}",
            warm_latency_s=f"{warm_s:.4f}", frames=len(execution.detailed_result.frames),
            segments=len(segments), labels=json.dumps(sorted({s.emotion for s in segments})))
    say("infer-launches", **launches)
    if launches["power_mel_log"] != len(clips) or launches["flash_attention_fwd"] != 32 * len(clips):
        raise AssertionError(f"main path launches {launches}, expected K1={len(clips)} K2={32 * len(clips)}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed.", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card.", file=sys.stderr)
        return 2
    if not (REPO / "ser_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository (ser_tpu_torch/ missing).", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    phase = "env"
    try:
        env = phase_environment()
        phase = "K1"
        k1 = phase_k1()
        phase = "K2"
        k2 = phase_k2()
        phase = "encoder"
        per_encode = phase_encoder()
        phase = "infer"
        launches = phase_infer()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1

    k1.update(launches=launches["power_mel_log"], launches_per_encode=per_encode["k1_per_encode"])
    k2.update(launches=launches["flash_attention_fwd"], launches_per_encode=per_encode["k2_per_encode"])
    print(json.dumps({"kernels": [k1, k2]}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
