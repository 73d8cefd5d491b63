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
   and at T = 1409 (one valid row in the last 128-row tile), against its plain
   version in float32, with SDPA's time as the yardstick; then K2-bwd (its
   backward: Δ, dK/dV and dQ kernels) at the training step's shapes and at
   T = 1409: K2's log-sum-exp against ``torch.logsumexp``, dq, dk and dv
   against the plain backward in float32 (with two planted faults its limit
   must catch), dq bit for bit on two runs, and its time beside the plain
   version's, SDPA's backward and its bound. Each line gives the achieved
   TFLOP/s, the share of the bound and the time over SDPA's;
4. K3 (LayerNorm → fused QKV), K4 (cached self-attention + out-projection +
   residual, with poisoned future cache slots at positions 0, 100 and 447) and
   K5 (the cross-attention block and its float32 weights) at large-v3's decode
   shapes with 2 rows, each against its plain version in float32, each with a
   planted fault its limit must catch, and with its time, the plain version's,
   the unfused PyTorch route's and its bound; then ``grad-guard``: K1 and K3,
   which have no backward, refuse a CUDA input that requires grad;
5. the large-v3 encoder at full width (32 layers, seeded random weights, bf16)
   on 8 windows: audio-seconds per second, MFU, launches per encode, and a
   2-layer full-width card-vs-CPU check of the same weights;
6. the full-width large-v3 greedy KV-cache decode (seeded random weights,
   bf16) over the encoder states of 2 windows, 448-token budget, through the
   kernels and through PyTorch ops: ms per step, tokens per second, launches,
   the two routes' logits over the positions before their first differing
   token, a device-time profile of each, and a 2-layer card-vs-CPU check;
7. ``WhisperForTranscription.transcribe_words`` on a 60 s synthetic clip at
   full width (no VAD, no retries), cold and warm, at the 448- and the
   96-token budget, with the launches of K1-K5;
8. ``ser_tpu_torch.api.infer(profile="accurate")`` on three synthetic clips at
   full width;
9. ``train``: the encoder fine-tuning step as ``bench.py``'s train lane runs it
   (large-v3 at full width, float32 master weights, bf16 compute, remat
   ``"dots"``, adafactor(1e-4), batch 4 × 30 s, 3 steps per call through
   ``make_sharded_train_loop``): ms per step, audio-seconds per second, MFU,
   peak memory, launches of K1, K2 and K2-bwd per step, finite losses and
   moving parameters, a device-time profile of one step, and a 2-layer
   full-width check of one step's loss and gradients against float32 on the
   CPU.

Phases 6-9 set the launch counts of the kernels they run to 0 just before
their run and read them just after.

It prints a ``kernels`` JSON line, the card's name and power limit, and, as
its last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line, as does a machine with no CUDA device or a directory
without the port.
"""

from __future__ import annotations

import gc
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

# Without this, a torch.profiler run leaves CUPTI's callbacks on after it
# ends, and every later PyTorch op costs more host time (6.5 -> 12 us per op on
# an H100 host): the host-bound timings of the phases after the first profile
# (transcribe, infer, train) read 1.5-1.9x too slow, and a second profile of a
# short run traced no device events. Kineto reads it when a trace stops.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

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
# that. Phase K2 also checks that the limit catches a kernel that lets the keys
# past T in the last key tile (36 of 128 at T = 1500) into the softmax as zeros,
# and holds the kernel to the same limit at T = 1409 (11 * 128 + 1: one valid
# key and query in the last tile).
K2_REL_L2_TOLERANCE = 7e-3
# K2's log-sum-exp (natural log, about 8 at T = 1500) against torch.logsumexp
# of the float32 scores: float32 sums in another order.
K2_LSE_TOLERANCE = 1e-4
# K2-bwd, relative L2 error of dq, dk and dv against the float32 plain version
# on the same bf16 inputs. The kernel rounds P and dS to bf16 before their
# products, and reads the bf16 forward output for Δ: 0.0024, 0.0023 and 0.0024
# measured on an H100 (as a CPU emulation of those roundings predicted), and
# the limit is about 3x that. Phase K2-bwd checks that the limit catches a
# backward without Δ (0.13 on dq) and one whose P lets the 36 zero keys that
# pad the last tile into its normalizer (0.014 on each), and holds the kernel
# to the same limit at T = 1409.
K2_BWD_REL_L2_TOLERANCE = 7e-3
# Full-width train step, 2 layers, batch 2: loss and named gradients with bf16
# compute and the kernels on the card against float32 on the CPU, same
# weights and inputs. Measured on an H100: loss 5.9e-6 relative, gradients
# 0.023-0.025 rel L2 (bf16 activations throughout); the gradient limit is
# about 3x that, the loss limit far above its reading.
TRAIN_CHECK_LOSS_BOUND = 1e-3
TRAIN_CHECK_GRAD_REL_L2_BOUND = 7.5e-2
# Full-width encoder, 2 layers: bf16 weights and activations on the card
# against float32 on the CPU, same weights (about 3.6x the measured 0.00562).
ENCODER_REL_L2_BOUND = 2e-2
# K3, K4, K5: relative L2 error of the kernel (bf16 in and out) against its
# plain version in float32 on the same bf16 inputs. The kernels' own error is
# bf16 rounding at the rounding points they share with the unfused decode (the
# LayerNorm output, each product's output, the scores, P, the head outputs).
# Each limit is about 3x its reading on an H100 (K3 0.0028, K4 0.0039 at the
# worst of its three positions, K5 0.0097 and 0.0123 on its float32 weights,
# where the bf16 rounding of the peaked scores shows), and each phase checks
# that its limit catches one planted fault.
K3_REL_L2_TOLERANCE = 1e-2
K4_REL_L2_TOLERANCE = 1e-2
K5_REL_L2_TOLERANCE = 4e-2
# K5's float32 weights: each row sums to 1.
K5_WEIGHT_SUM_TOLERANCE = 1e-5
# Full-width decoder: fused (kernels) against unfused (PyTorch ops) logits,
# both bf16, over the positions before their first differing token (about
# 3.5x the 0.0144 measured on an H100).
DECODE_LOGITS_REL_L2_BOUND = 5e-2
# Full-width decoder, 2 layers: bf16 kernels on the card against float32 plain
# versions on the CPU, logits of the first 8 steps, same weights and inputs
# (about 3x the 0.0063 measured).
DECODE_CHECK_REL_L2_BOUND = 2e-2
# Bytes of weight copies cycled through when timing a decode-step kernel: the
# decode reads 32 layers' weights per step, far more than the 50 MB L2, so
# each call finds its weights in device memory, not in L2.
ROTATION_BYTES = 160e6

RAVDESS_LABELS = ["angry", "calm", "disgust", "fearful", "happy", "neutral", "sad", "surprised"]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{key}={value}" for key, value in fields.items()), flush=True)


_SLEEP_CYCLES_PER_MS: list[float] = []


def _hold_card(ms: float) -> None:
    """Keeps the card busy for about ``ms`` (``torch.cuda._sleep``, calibrated once)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        cycles = 10_000_000
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def cuda_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls.

    The card is held in a sleep while the host enqueues the calls, so that the
    events time the calls back to back on the card and not the host's pace
    (a decode-step kernel takes less time on the card than its launch on the
    host). Raises if the host took longer to enqueue than the card slept.
    """
    import torch

    started = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - started) * 1e3 / warmup
    hold_ms = 2.0 * host_ms * iters + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _hold_card(hold_ms)
    start.record()
    enqueue_started = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - enqueue_started) * 1e3
    end.record()
    torch.cuda.synchronize()
    if enqueue_ms > hold_ms:
        raise AssertionError(f"the host took {enqueue_ms:.1f} ms to enqueue, longer than the card's {hold_ms:.1f} ms hold")
    return start.elapsed_time(end) / iters


def rotating_ms(fn, argument_sets, *, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` calls, cycling through
    ``argument_sets`` so that each call reads operands that are not in L2."""
    count = len(argument_sets)
    calls = iter(range(10**9))
    return cuda_ms(lambda: fn(*argument_sets[next(calls) % count]), iters=iters, warmup=warmup)


def copies_for(nbytes: float) -> int:
    """How many copies of ``nbytes`` of operands exceed ``ROTATION_BYTES``."""
    return max(2, math.ceil(ROTATION_BYTES / nbytes))


def rel_l2(value, reference) -> float:
    return ((value.float() - reference.float()).norm() / reference.float().norm()).item()


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
    say("host", us_per_op=json.dumps([round(host_us_per_op(), 2) for _ in range(3)]))
    return {"smi": smi}


def host_us_per_op(n: int = 20000) -> float:
    """Host microseconds per PyTorch op on the card (a loop of 1-element adds; the card outpaces it)."""
    import torch

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - started) / n * 1e6


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


# A sequence length with one valid key and query in the kernels' last 128-row tile.
RAGGED_SEQ = 1409


def _rates(flops: float, ms: float, bound: float, library_ms: float) -> dict:
    """Achieved TFLOP/s, the share of the bound, and the time over the library call's."""
    return {"tflops": f"{flops / ms / 1e9:.1f}", "bound_share": f"{bound / ms:.3f}",
            "ms_over_library": f"{ms / library_ms:.3f}"}


def _k2_ragged_rel_l2(batch: int, heads: int, dim: int) -> float:
    """K2 (unmasked) against its plain version at T = RAGGED_SEQ."""
    import torch

    from ser_tpu_torch.models import attention

    q, k, v = (torch.randn(batch, RAGGED_SEQ, heads, dim, device="cuda").to(torch.bfloat16) for _ in range(3))
    out = attention.flash_attention(q, k, v)
    return rel_l2(out, attention.attention_reference(q.float(), k.float(), v.float()))


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
            tail = torch.zeros(batch, -seq % attention._TILE, heads, dim, device="cuda")
            leaky = attention.attention_reference(
                q.float(), torch.cat([k.float(), tail], 1), torch.cat([v.float(), tail], 1)
            )
            tail_leak_rel_l2 = ((leaky - ref).norm() / ref.norm()).item()
            if not tail_leak_rel_l2 > K2_REL_L2_TOLERANCE:
                raise AssertionError(f"K2's limit would pass unmasked tail keys: {tail_leak_rel_l2}")
            del leaky
    ragged_rel_l2 = _k2_ragged_rel_l2(batch, heads, dim)
    if not ragged_rel_l2 <= K2_REL_L2_TOLERANCE:
        raise AssertionError(f"K2 disagrees with its plain version at T = {RAGGED_SEQ}: {ragged_rel_l2}")
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
        ragged_rel_l2_err=ragged_rel_l2, rel_l2_tolerance=K2_REL_L2_TOLERANCE, tail_leak_rel_l2=tail_leak_rel_l2,
        ref_abs=ref_size, ms=f"{ms:.4f}", masked_ms=f"{masked_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
        **_rates(flops, ms, bound, library_ms))
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ser_tpu/models/attention.py:117",
        "max_abs_err": err,
        "rel_l2_err": rel_l2,
        "masked_max_abs_err": masked_err,
        "masked_rel_l2_err": masked_rel_l2,
        "ragged_rel_l2_err": ragged_rel_l2,
        "tolerance": K2_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "masked_ms": masked_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _k2_bwd_ragged_rel_l2(batch: int, heads: int, dim: int, scale: float) -> list[float]:
    """K2-bwd's dq, dk, dv against the plain backward at T = RAGGED_SEQ, and K2's lse within its limit."""
    import torch

    from ser_tpu_torch.models import attention

    q, k, v, dout = (torch.randn(batch, RAGGED_SEQ, heads, dim, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = attention.flash_attention(q, k, v, return_lse=True)
    grads = attention.flash_attention_backward(q, k, v, out, lse, dout)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    ref_out, ref_lse = attention.attention_with_lse_reference(qf, kf, vf, scale)
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= K2_LSE_TOLERANCE:
        raise AssertionError(f"K2's log-sum-exp at T = {RAGGED_SEQ} disagrees: {lse_err} > {K2_LSE_TOLERANCE}")
    refs = attention.attention_backward_reference(qf, kf, vf, ref_out, ref_lse, dof, scale)
    return [rel_l2(g, r) for g, r in zip(grads, refs)]


def phase_k2_bwd() -> dict:
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.models import attention

    torch.manual_seed(2)
    batch, seq, heads, dim = 4, 1500, 20, 64  # the training step's shapes
    q, k, v, dout = (torch.randn(batch, seq, heads, dim, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(dim)
    out, lse = attention.flash_attention(q, k, v, return_lse=True)
    grads = attention.flash_attention_backward(q, k, v, out, lse, dout)
    again = attention.flash_attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again

    # The plain version in float32 on the same bf16 inputs, with its own output and log-sum-exp.
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    ref_out, ref_lse = attention.attention_with_lse_reference(qf, kf, vf, scale)
    lse_err = (lse - ref_lse).abs().max().item()
    refs = attention.attention_backward_reference(qf, kf, vf, ref_out, ref_lse, dof, scale)
    errs = [rel_l2(g, r) for g, r in zip(grads, refs)]
    # Planted faults: a backward without Δ (out = 0 makes Δ = 0), and one whose
    # P lets the zero keys that pad the last key tile into its normalizer.
    no_delta = attention.attention_backward_reference(qf, kf, vf, torch.zeros_like(ref_out), ref_lse, dof, scale)
    pad = -seq % attention._TILE
    leaky_lse = torch.logaddexp(ref_lse, torch.full_like(ref_lse, math.log(pad)))
    leaky = attention.attention_backward_reference(qf, kf, vf, ref_out, leaky_lse, dof, scale)
    no_delta_errs = [rel_l2(g, r) for g, r in zip(no_delta, refs)]
    leaky_errs = [rel_l2(g, r) for g, r in zip(leaky, refs)]
    del no_delta, leaky
    names = ("dq", "dk", "dv")
    if not lse_err <= K2_LSE_TOLERANCE:
        raise AssertionError(f"K2's log-sum-exp disagrees with torch.logsumexp: {lse_err} > {K2_LSE_TOLERANCE}")
    if not all(e <= K2_BWD_REL_L2_TOLERANCE for e in errs):
        raise AssertionError(f"K2-bwd disagrees with its plain version: rel L2 {dict(zip(names, errs))}")
    if not same_bits:
        raise AssertionError("K2-bwd gave different bits on two runs")
    ragged_errs = _k2_bwd_ragged_rel_l2(batch, heads, dim, scale)
    if not all(e <= K2_BWD_REL_L2_TOLERANCE for e in ragged_errs):
        raise AssertionError(f"K2-bwd disagrees with its plain version at T = {RAGGED_SEQ}: {ragged_errs}")
    for label, fault in (("no-delta", no_delta_errs), ("tail-leak", leaky_errs)):
        if not max(fault) > K2_BWD_REL_L2_TOLERANCE:
            raise AssertionError(f"K2-bwd's limit would pass the {label} fault: {fault}")

    ms = cuda_ms(lambda: attention.flash_attention_backward(q, k, v, out, lse, dout))
    plain_ms = cuda_ms(lambda: attention.attention_backward_reference(q, k, v, out, lse, dout, scale), iters=3,
                       warmup=1)
    # SDPA's backward: forward + backward minus forward, on the same tensors.
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = dout.transpose(1, 2)

    def sdpa_forward():
        return F.scaled_dot_product_attention(qt, kt, vt)

    sdpa_fwd_ms = cuda_ms(sdpa_forward)
    sdpa_both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_forward(), (qt, kt, vt), dot))
    library_ms = sdpa_both_ms - sdpa_fwd_ms
    flops = 10.0 * batch * heads * seq * seq * dim  # S (recomputed), dP, dV, dK, dQ
    bytes_moved = 8 * q.numel() * 2 + lse.numel() * 4
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
    say("K2-bwd", shape=f"(B,T,H,D)=({batch},{seq},{heads},{dim}) bf16", lse_max_abs_err=lse_err,
        lse_tolerance=K2_LSE_TOLERANCE, rel_l2_err=json.dumps(dict(zip(names, errs))),
        ragged_rel_l2_err=json.dumps(dict(zip(names, ragged_errs))), rel_l2_tolerance=K2_BWD_REL_L2_TOLERANCE,
        no_delta_fault=json.dumps(dict(zip(names, no_delta_errs))),
        tail_leak_fault=json.dumps(dict(zip(names, leaky_errs))), same_bits_twice=same_bits, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}", sdpa_fwd_ms=f"{sdpa_fwd_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=bound_by, **_rates(flops, ms, bound, library_ms))
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ser_tpu/models/attention.py:96",
        "max_abs_err": max((g.float() - r).abs().max().item() for g, r in zip(grads, refs)),
        "rel_l2_err": max(errs),
        "lse_max_abs_err": lse_err,
        "ragged_rel_l2_err": max(ragged_errs),
        "tolerance": K2_BWD_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def phase_grad_guard() -> dict:
    """A kernel without an autograd Function refuses an input that requires grad (K1, K3)."""
    import torch

    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    spec = torch.zeros(1, 8, 402, device="cuda", requires_grad=True)
    fb = torch.zeros(201, 128, device="cuda")
    d = 1280
    x = torch.zeros(2, d, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    ln, w, b = (torch.zeros(shape, device="cuda", dtype=torch.bfloat16) for shape in ((1, d), (d, 3 * d), (1, 3 * d)))
    refused = {}
    for name, call in (("K1", lambda: log_mel.power_mel_log(spec, fb)),
                       ("K3", lambda: dsk.ln_qkv_project(x, ln, ln, w, b, eps=1e-5))):
        try:
            call()
        except RuntimeError as err:
            refused[name] = "no backward" in str(err)
        else:
            refused[name] = False
    with torch.no_grad():  # the same calls without grad mode launch
        log_mel.power_mel_log(spec, fb)
        dsk.ln_qkv_project(x, ln, ln, w, b, eps=1e-5)
    torch.cuda.synchronize()
    say("grad-guard", refused=json.dumps(refused))
    if not all(refused.values()):
        raise AssertionError(f"a kernel without a backward took an input that requires grad: {refused}")
    return refused


class _Affine:
    """An ``nn.Linear``/``LayerNorm`` look-alike: what the unfused decode ops read."""

    def __init__(self, weight, bias=None) -> None:
        self.weight = weight
        self.bias = bias


def _bf16(generator, *shape, scale: float = 1.0, shift: float = 0.0):
    import torch

    values = torch.randn(*shape, generator=generator, device="cuda") * scale + shift
    return values.to(torch.bfloat16).contiguous()


def phase_k3() -> dict:
    import torch

    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    rows, d, n_out, eps = 2, 1280, 3840, 1e-5
    gen = torch.Generator(device="cuda").manual_seed(3)

    def operands():
        # A residual stream with an offset (so the LayerNorm's mean matters).
        return (
            _bf16(gen, rows, d, shift=0.5),
            _bf16(gen, 1, d, scale=0.1, shift=1.0),
            _bf16(gen, 1, d, scale=0.1),
            _bf16(gen, d, n_out, scale=d**-0.5),
            _bf16(gen, 1, n_out, scale=0.1),
        )

    args = operands()
    out = dsk.ln_qkv_project(*args, eps=eps)
    ref = dsk.ln_qkv_project_reference(*(t.float() for t in args), eps=eps)
    torch.cuda.synchronize()
    err, rel = (out.float() - ref).abs().max().item(), rel_l2(out, ref)
    # Planted fault: a LayerNorm that does not subtract the mean.
    x, scale, bias, w, b = (t.float() for t in args)
    no_mean = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale + bias
    fault = rel_l2(no_mean @ w + b, ref)
    if not rel <= K3_REL_L2_TOLERANCE:
        raise AssertionError(f"K3 disagrees with its plain version: rel L2 {rel} > {K3_REL_L2_TOLERANCE}")
    if not fault > K3_REL_L2_TOLERANCE:
        raise AssertionError(f"K3's limit would pass a LayerNorm without its mean: {fault}")

    bytes_moved = 2 * (rows * d + 2 * d + d * n_out + n_out + rows * n_out)
    sets = [args] + [operands() for _ in range(copies_for(bytes_moved) - 1)]
    ms = rotating_ms(lambda *a: dsk.ln_qkv_project(*a, eps=eps), sets)
    plain_ms = rotating_ms(lambda *a: dsk.ln_qkv_project_reference(*a, eps=eps), sets)
    unfused_ms = rotating_ms(
        lambda x, s, bi, w, b: wd._dense_kernel({"kernel": w, "bias": b}, wd._layer_norm(_Affine(s, bi), x, eps),
                                                torch.bfloat16),
        sets,
    )
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=2.0 * rows * d * n_out, peak_flops=PEAK_BF16_FLOPS)
    say("K3", shape=f"x({rows},{d}) W({d},{n_out}) bf16", max_abs_err=err, rel_l2_err=rel,
        rel_l2_tolerance=K3_REL_L2_TOLERANCE, no_mean_fault_rel_l2=fault, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", unfused_ms=f"{unfused_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
        gb_per_s=f"{bytes_moved / ms / 1e6:.1f}")
    return {
        "name": "ln_qkv_project",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:94",
        "max_abs_err": err,
        "rel_l2_err": rel,
        "tolerance": K3_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "plain_ms": plain_ms,
        "unfused_ms": unfused_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_k4() -> dict:
    import torch

    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    rows, heads, head_dim, s_max, d = 2, 20, 64, 448, 1280
    gen = torch.Generator(device="cuda").manual_seed(4)

    def operands():
        return (
            _bf16(gen, rows, heads, head_dim),
            _bf16(gen, rows, heads, head_dim, s_max),
            _bf16(gen, rows, heads, s_max, head_dim),
            _bf16(gen, heads, head_dim, d, scale=d**-0.5),
            _bf16(gen, 1, d, scale=0.1),
            _bf16(gen, rows, d, scale=0.1),
        )

    args = operands()
    q, k, v, w_out, b_out, x = args
    readings = {}
    for position in (0, 100, s_max - 1):
        # Poison the future slots: a kernel that reads them cannot agree.
        k_p, v_p = k.clone(), v.clone()
        k_p[..., position + 1 :] = 1e4
        v_p[:, :, position + 1 :, :] = -1e4
        out = dsk.self_attend_and_out(q, k_p, v_p, w_out, b_out, x, position)
        ref = dsk.self_attend_and_out_reference(q.float(), k_p.float(), v_p.float(), w_out.float(), b_out.float(),
                                                x.float(), position)
        torch.cuda.synchronize()
        rel = rel_l2(out, ref)
        if not rel <= K4_REL_L2_TOLERANCE:
            raise AssertionError(f"K4 at position {position} disagrees with its plain version: rel L2 {rel}")
        fault = None
        if position + 1 < s_max:
            # Planted fault: one key past position, into the poisoned slots.
            leaky = dsk.self_attend_and_out_reference(q.float(), k_p.float(), v_p.float(), w_out.float(),
                                                      b_out.float(), x.float(), position + 1)
            fault = rel_l2(leaky, ref)
            if not fault > K4_REL_L2_TOLERANCE:
                raise AssertionError(f"K4's limit would pass a read one key past position {position}: {fault}")
        readings[position] = ((out.float() - ref).abs().max().item(), rel, fault)

    position = s_max - 1
    keys = position + 1
    bytes_moved = 2 * (q.numel() + 2 * rows * heads * head_dim * keys + w_out.numel() + 2 * d + 2 * rows * d)
    flops = 4.0 * rows * heads * head_dim * keys + 2.0 * rows * heads * head_dim * d
    sets = [args] + [operands() for _ in range(copies_for(bytes_moved) - 1)]
    ms = rotating_ms(lambda *a: dsk.self_attend_and_out(*a, position), sets)
    plain_ms = rotating_ms(lambda *a: dsk.self_attend_and_out_reference(*a, position), sets)
    bias_row = torch.where(torch.arange(s_max, device="cuda") <= position, 0.0, -1e30)

    def unfused(q, k, v, w_out, b_out, x):
        out = wd._attend_self_step(q[:, None], k, v, bias_row=bias_row, compute_dtype=torch.bfloat16)
        return x + wd._dense(_Affine(w_out.reshape(heads * head_dim, d).t(), b_out[0]), out.reshape(rows, -1),
                             torch.bfloat16)

    unfused_ms = rotating_ms(unfused, sets)
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
    err, rel, _ = readings[position]
    say("K4", shape=f"q({rows},{heads},{head_dim}) cache({rows},{heads},{head_dim},{s_max}) bf16",
        positions=json.dumps({str(p): [f"{e:.3g}", f"{r:.5f}", None if f is None else f"{f:.3g}"]
                              for p, (e, r, f) in readings.items()}),
        rel_l2_tolerance=K4_REL_L2_TOLERANCE, timed_position=position, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        unfused_ms=f"{unfused_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
        gb_per_s=f"{bytes_moved / ms / 1e6:.1f}")
    return {
        "name": "self_attend_and_out",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:175",
        "max_abs_err": err,
        "rel_l2_err": max(r for _, r, _ in readings.values()),
        "tolerance": K4_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "plain_ms": plain_ms,
        "unfused_ms": unfused_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_k5() -> dict:
    import torch

    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    rows, heads, head_dim, s_len, d, eps = 2, 20, 64, 1500, 1280, 1e-5
    gen = torch.Generator(device="cuda").manual_seed(5)

    def operands():
        # Keys at twice unit scale give peaked attention rows, as trained
        # alignment heads have; a small residual keeps the attention's share visible.
        return (
            _bf16(gen, rows, d, scale=0.1, shift=0.05),
            _bf16(gen, 1, d, scale=0.1, shift=1.0),
            _bf16(gen, 1, d, scale=0.1),
            _bf16(gen, heads, d, head_dim, scale=d**-0.5),
            _bf16(gen, heads, 1, head_dim, scale=0.1),
            _bf16(gen, rows, heads, head_dim, s_len, scale=2.0),
            _bf16(gen, rows, heads, s_len, head_dim),
            _bf16(gen, heads, head_dim, d, scale=d**-0.5),
            _bf16(gen, 1, d, scale=0.1),
        )

    args = operands()
    out, weights = dsk.cross_attention_step(*args, eps=eps)
    ref, ref_weights = dsk.cross_attention_step_reference(*(t.float() for t in args), eps=eps)
    torch.cuda.synchronize()
    err, rel = (out.float() - ref).abs().max().item(), rel_l2(out, ref)
    weights_rel = rel_l2(weights, ref_weights)
    sum_err = (weights.sum(-1) - 1.0).abs().max().item()
    # Planted fault: a softmax that leaves out the last partial 64-key tile (1500 = 23 * 64 + 28).
    kept = s_len // 64 * 64
    x, scale, bias, w_q, b_q, k, v, w_out, b_out = (t.float() for t in args)
    short, _ = dsk.cross_attention_step_reference(x, scale, bias, w_q, b_q, k[..., :kept].contiguous(),
                                                  v[:, :, :kept].contiguous(), w_out, b_out, eps=eps)
    fault = rel_l2(short, ref)
    if not rel <= K5_REL_L2_TOLERANCE or not weights_rel <= K5_REL_L2_TOLERANCE:
        raise AssertionError(f"K5 disagrees with its plain version: rel L2 {rel}, weights {weights_rel}")
    if not sum_err <= K5_WEIGHT_SUM_TOLERANCE:
        raise AssertionError(f"K5's weight rows do not sum to 1: {sum_err}")
    if not fault > K5_REL_L2_TOLERANCE:
        raise AssertionError(f"K5's limit would pass a softmax without its last partial tile: {fault}")

    bytes_moved = (2 * (2 * rows * d + 2 * d + 2 * heads * d * head_dim + heads * head_dim + d
                        + 2 * rows * heads * head_dim * s_len) + 4 * heads * rows * s_len)
    flops = 2.0 * rows * d * heads * head_dim * 2 + 4.0 * rows * heads * head_dim * s_len
    sets = [args] + [operands() for _ in range(copies_for(bytes_moved) - 1)]
    ms = rotating_ms(lambda *a: dsk.cross_attention_step(*a, eps=eps), sets)
    plain_ms = rotating_ms(lambda *a: dsk.cross_attention_step_reference(*a, eps=eps), sets)

    def unfused(x, scale, bias, w_q, b_q, k, v, w_out, b_out):
        h = wd._layer_norm(_Affine(scale[0], bias[0]), x[:, None], eps)
        q_lin = _Affine(w_q, b_q.reshape(-1))
        q = wd._split_heads(wd._dense(q_lin, h, torch.bfloat16), heads)
        out, attn = wd._attend_cross_step(q, k, v, compute_dtype=torch.bfloat16)
        return x + wd._dense(_Affine(w_out.reshape(heads * head_dim, d).t(), b_out[0]), out.reshape(rows, -1),
                             torch.bfloat16), attn

    # The unfused route reads the Q projection as an nn.Linear weight (out, in).
    unfused_sets = [(a[0], a[1], a[2], a[3].permute(0, 2, 1).reshape(heads * head_dim, d).contiguous(), *a[4:])
                    for a in sets]
    unfused_ms = rotating_ms(unfused, unfused_sets)
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
    say("K5", shape=f"x({rows},{d}) K/V({rows},{heads},{head_dim},{s_len}) bf16", max_abs_err=err, rel_l2_err=rel,
        weights_rel_l2_err=weights_rel, weight_sum_err=sum_err, rel_l2_tolerance=K5_REL_L2_TOLERANCE,
        tail_fault_rel_l2=fault, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", unfused_ms=f"{unfused_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=bound_by, gb_per_s=f"{bytes_moved / ms / 1e6:.1f}")
    return {
        "name": "cross_attention_step",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:269",
        "max_abs_err": err,
        "rel_l2_err": rel,
        "weights_rel_l2_err": weights_rel,
        "weight_sum_err": sum_err,
        "tolerance": K5_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": ms,
        "plain_ms": plain_ms,
        "unfused_ms": unfused_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _encoder_flops(config, n_windows: int) -> float:
    """2·MACs of the conv stem and the per-layer matmuls at 1500 states (bench.py's count)."""
    t_mel, t = 3000, 1500
    d, layers, ffn = config.d_model, config.encoder_layers, 4 * config.d_model
    macs_conv = t_mel * 3 * config.n_mels * d + t * 3 * d * d
    macs_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * ffn
    return 2.0 * (macs_conv + layers * macs_layer) * n_windows


_KERNEL_GROUPS = (
    ("K3-K5 decode_step", ("gemv_kernel", "attend_kernel")),
    ("K2 flash_attention", ("flash_attention_fwd_kernel",)),
    ("K2-bwd flash_attention_bwd", ("flash_attention_bwd",)),
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


def _profile(run, label: str) -> str:
    """Device time of one ``run()`` by kernel group, and the device's busy share.

    The profiler runs one warm-up step first, so the profiled step's wall
    time holds no profiler start-up. Only device events (kernels, memsets,
    copies) are summed. Informational: where the profiler cannot trace the
    card, it says so and the run goes on (the phase's numbers come from the
    host clock and CUDA events).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    # A trace that starts right after another one ended (CUPTI torn down, see
    # TEARDOWN_CUPTI above) may hold no device events: trace once more.
    for _attempt in range(2):
        traced = {}
        try:
            with profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: traced.setdefault("events", p.key_averages()),
            ) as prof:
                run()
                torch.cuda.synchronize()
                prof.step()
                started = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - started) * 1e3
                prof.step()
        except RuntimeError as err:
            return f"unavailable ({err})"
        # Device events (kernels, memsets, copies) take no host time of their
        # own; an operator's row repeats the device time of the kernels it
        # launched, and the step's own row ("ProfilerStep*") spans all of them.
        kernels = [
            e
            for e in traced.get("events", [])
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")
        ]
        if kernels:
            break
    else:
        return "unavailable (no device events traced)"
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict[str, float] = {}
    for event in kernels:
        group = _kernel_group(event.key)
        groups[group] = groups.get(group, 0.0) + event.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    rows = [[e.key[:72], e.count, round(e.self_device_time_total / 1e3, 3)] for e in top]
    say(f"{label}-kernels", top=json.dumps(rows))
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
    breakdown = _profile(lambda: wm.encode_mel_chunks(encoder, chunks), "encoder")
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


class SyntheticTokenizer:
    """large-v3's special-token ids, and one word per token (``bench.py``'s stand-in).

    The card's machine has no Whisper tokenizer files and no ``transformers``.
    """

    SPECIALS = {
        "<|startoftranscript|>": 50258,
        "<|endoftext|>": 50257,
        "<|en|>": 50259,
        "<|transcribe|>": 50360,
        "<|0.00|>": 50365,
    }
    unk_token_id = 50256

    def convert_tokens_to_ids(self, tokens):
        return [self.SPECIALS.get(token, self.unk_token_id) for token in tokens]

    def decode(self, ids):
        return "".join(f" t{i}" for i in ids)


PREFIX = [50258, 50259, 50360]
EOT, TIMESTAMP_BEGIN = 50257, 50365


def _decode_steps(lengths, prefix_len: int, max_len: int) -> int:
    """Loop steps of one greedy decode: it stops after the last row's EOT, or at max_len - 1."""
    return min(max_len - 1, prefix_len + int(lengths.max().item()))


def _lockstep_logits_rel_l2(decoder, config, weights, states, tokens, positions: int) -> float:
    """Relative L2 between the fused and unfused routes' logits, both fed ``tokens``."""
    import torch

    from ser_tpu_torch.models import whisper_decode as wd

    n_layers, heads, max_len = config.decoder_layers, config.n_heads, config.max_target_positions
    head_dim = config.d_model // heads
    batch, dtype = states.shape[0], decoder.tok_embed.dtype
    with torch.inference_mode():
        cross = wd._precompute_cross_kv(decoder, states, n_layers, heads, dtype)
        caches = {
            fused: (
                [torch.zeros((batch, heads, head_dim, max_len), dtype=dtype, device=states.device) for _ in range(n_layers)],
                [torch.zeros((batch, heads, max_len, head_dim), dtype=dtype, device=states.device) for _ in range(n_layers)],
            )
            for fused in (True, False)
        }
        diff_sq = ref_sq = 0.0
        for position in range(positions):
            logits = {}
            for fused, (self_k, self_v) in caches.items():
                logits[fused], _ = wd._decoder_token_step(
                    decoder, weights, *cross, self_k, self_v, tokens[:, position], position,
                    config=config, compute_dtype=dtype, fused=fused,
                )
            diff_sq += (logits[True] - logits[False]).pow(2).sum().item()
            ref_sq += logits[False].pow(2).sum().item()
    return math.sqrt(diff_sq / ref_sq)


def _decode_check(states_cpu) -> float:
    """2-layer full-width decoder: bf16 kernels on the card against float32 on the CPU."""
    import torch

    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models import whisper_decode as wd

    config = wm.WhisperConfig(decoder_layers=2)
    state = wm.random_whisper_decoder_state(config, seed=5, device="cpu")
    state["pos_embed"] = torch.randn(state["pos_embed"].shape, generator=torch.Generator().manual_seed(6)) * 0.02
    routes = {
        "card": (wm.build_whisper_decoder(config, state, device=torch.device("cuda"), dtype=torch.bfloat16),
                 states_cpu.cuda(), torch.bfloat16, True),
        "cpu": (wm.build_whisper_decoder(config, state, device=torch.device("cpu"), dtype=torch.float32),
                states_cpu, torch.float32, False),
    }
    steps, logits = 8, {}
    tokens = None
    with torch.inference_mode():
        for name in ("cpu", "card"):
            decoder, states, dtype, fused = routes[name]
            weights = wd.prepare_decode_weights(decoder, config, fused=fused)
            cross = wd._precompute_cross_kv(decoder, states, 2, config.n_heads, dtype)
            batch, head_dim = states.shape[0], config.d_model // config.n_heads
            self_k = [torch.zeros((batch, config.n_heads, head_dim, 448), dtype=dtype, device=states.device) for _ in range(2)]
            self_v = [torch.zeros((batch, config.n_heads, 448, head_dim), dtype=dtype, device=states.device) for _ in range(2)]
            if tokens is None:  # the CPU route picks the tokens both routes are fed
                tokens = torch.full((batch, steps), EOT, dtype=torch.long)
                tokens[:, :3] = torch.tensor(PREFIX)
            out = []
            for position in range(steps):
                step_logits, _ = wd._decoder_token_step(
                    decoder, weights, *cross, self_k, self_v, tokens[:, position].to(states.device), position,
                    config=config, compute_dtype=dtype, fused=fused,
                )
                out.append(step_logits.float().cpu())
                if name == "cpu" and position + 1 < steps and position + 1 >= 3:
                    tokens[:, position + 1] = torch.argmax(step_logits, dim=-1)
            logits[name] = torch.stack(out)
    return rel_l2(logits["card"], logits["cpu"])


def phase_decode() -> dict:
    import numpy as np
    import torch

    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    # Encoder states of 2 windows from the port's full-width encoder.
    state = wm.random_whisper_encoder_state(config, seed=0, device=cuda)
    encoder = wm.build_whisper_encoder(config, state, device=cuda, dtype=torch.bfloat16)
    del state
    rng = np.random.default_rng(1)
    chunks = torch.from_numpy((0.2 * rng.standard_normal((2, wm.CHUNK_SAMPLES))).astype(np.float32)).to(cuda)
    states = wm.encode_mel_chunks(encoder, chunks)
    del encoder
    started = time.perf_counter()
    state = wm.random_whisper_decoder_state(config, seed=2, device=cuda)
    decoder = wm.build_whisper_decoder(config, state, device=cuda, dtype=torch.bfloat16)
    del state
    weights = wd.prepare_decode_weights(decoder, config, fused=True)
    torch.cuda.synchronize()
    say("decoder-build", seconds=f"{time.perf_counter() - started:.2f}",
        params_m=f"{sum(p.numel() for p in decoder.parameters()) / 1e6:.1f}")
    kwargs = dict(prefix_len=3, align_spec=wd.default_alignment_spec(32, 20), compute_dtype=torch.bfloat16,
                  timestamp_begin=TIMESTAMP_BEGIN, weights=weights)

    def decode(fused: bool, budget: int = config.max_target_positions):
        import dataclasses

        cfg = dataclasses.replace(config, max_target_positions=budget)
        return wd.greedy_decode_kv_cache(decoder, cfg, states, PREFIX, EOT, fused=fused, **kwargs)

    for fused in (True, False):  # warm-up: cuBLAS handles, the allocator
        decode(fused, budget=16)
    torch.cuda.synchronize()
    routes = {}
    for label, fused in (("fused", True), ("unfused", False)):
        for counter in dsk.COUNTERS:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        tokens, lengths, align = decode(fused)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - started
        steps = _decode_steps(lengths, 3, config.max_target_positions)
        launches = {c.name: c.launches for c in dsk.COUNTERS}
        routes[label] = (tokens, steps, elapsed)
        say("decode", route=label, rows=tokens.shape[0], steps=steps, seconds=f"{elapsed:.4f}",
            ms_per_step=f"{elapsed / steps * 1e3:.4f}", tokens_per_s=f"{tokens.shape[0] * steps / elapsed:.1f}",
            lengths=lengths.tolist(), launches=json.dumps(launches),
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        if not torch.isfinite(align).all() or tokens.shape != (2, config.max_target_positions):
            raise AssertionError(f"decode ({label}) gave tokens {tuple(tokens.shape)} or non-finite alignment")
        expected = 32 * steps if fused else 0
        if any(count != expected for count in launches.values()):
            raise AssertionError(f"decode ({label}) launches {launches}, expected {expected} each")
        if fused:
            fused_launches = launches

    fused_tokens, steps, _ = routes["fused"]
    differ = (fused_tokens != routes["unfused"][0]).any(dim=0).nonzero()
    first_diff = int(differ[0].item()) if differ.numel() else config.max_target_positions
    positions = min(first_diff, steps)
    logits_rel = _lockstep_logits_rel_l2(decoder, config, weights, states, fused_tokens, positions)
    say("decode-compare", first_differing_position=first_diff, compared_positions=positions,
        logits_rel_l2=f"{logits_rel:.5f}", bound=DECODE_LOGITS_REL_L2_BOUND)
    if not logits_rel <= DECODE_LOGITS_REL_L2_BOUND:
        raise AssertionError(f"fused and unfused logits differ: rel L2 {logits_rel} > {DECODE_LOGITS_REL_L2_BOUND}")
    breakdown = _profile(lambda: decode(True, budget=64), "decode")
    say("decode-profile", route="fused", budget=64, detail=breakdown)
    breakdown = _profile(lambda: decode(False, budget=64), "decode-unfused")
    say("decode-profile", route="unfused", budget=64, detail=breakdown)
    del decoder, weights
    torch.cuda.empty_cache()

    check = _decode_check(states.float().cpu())
    say("decode-check", layers=2, d_model=config.d_model, steps=8, logits_rel_l2=f"{check:.5f}",
        bound=DECODE_CHECK_REL_L2_BOUND)
    if not check <= DECODE_CHECK_REL_L2_BOUND:
        raise AssertionError(f"card decoder disagrees with the CPU: rel L2 {check} > {DECODE_CHECK_REL_L2_BOUND}")
    return {
        "steps": steps,
        "fused_ms_per_step": routes["fused"][2] / steps * 1e3,
        "unfused_ms_per_step": routes["unfused"][2] / routes["unfused"][1] * 1e3,
        "launches_per_decode": fused_launches,
    }


def phase_transcribe() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from ser_tpu_torch.models import attention, word_timing
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    started = time.perf_counter()
    model = wm.WhisperForTranscription(
        config,
        wm.random_whisper_encoder_state(config, seed=0, device=cuda),
        wm.random_whisper_decoder_state(config, seed=2, device=cuda),
        SyntheticTokenizer(),
        device=cuda,
        compute_dtype="bfloat16",
    )
    # Random weights always look degenerate: retries would repeat the same work (bench.py:499-501).
    model.RETRY_TEMPERATURES = ()
    torch.cuda.synchronize()
    say("transcribe-build", seconds=f"{time.perf_counter() - started:.2f}")
    seconds = 60.0
    audio = (0.2 * np.random.default_rng(0).standard_normal(int(seconds * 16000))).astype(np.float32)
    counters = (log_mel.COUNTER, attention.COUNTER, *dsk.COUNTERS)
    # Spans of one call: the encode, the decode (with the alignment reduction
    # on the card) and the host's DTW word timing, each ended by a synchronize.
    spans: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            started = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - started
            return result

        return wrapper

    model._decode_chunk_batch = timed("decode", model._decode_chunk_batch)
    encode, word_timings = wm.encode_mel_chunks, word_timing.word_timings_from_matrix
    wm.encode_mel_chunks = timed("encode", encode)
    word_timing.word_timings_from_matrix = timed("word_timing", word_timings)

    def run():
        spans.clear()
        started = time.perf_counter()
        words = model.transcribe_words(audio, language="en", use_vad=False)
        torch.cuda.synchronize()
        return words, time.perf_counter() - started

    results = {}
    main_launches = None
    for budget in (config.max_target_positions, 96):
        model.config = dataclasses.replace(config, max_target_positions=budget)
        for counter in counters:
            counter.launches = 0
        words, cold = run()
        launches = {c.name: c.launches for c in counters}
        _, warm = run()
        if main_launches is None:
            main_launches = launches
        results[budget] = (cold, warm)
        say("transcribe", clip_seconds=seconds, windows=2, token_budget=budget, cold_latency_s=f"{cold:.4f}",
            warm_latency_s=f"{warm:.4f}", audio_s_per_s=f"{seconds / warm:.1f}", words=len(words),
            warm_spans_s=json.dumps({k: round(v, 4) for k, v in spans.items()}), launches=json.dumps(launches))
        starts = [w.start_seconds for w in words]
        if not words or any(not (0.0 <= w.start_seconds < w.end_seconds <= seconds + 1e-6) for w in words):
            raise AssertionError(f"transcript words are missing or outside the clip: {words[:3]}")
        if starts != sorted(starts):
            raise AssertionError("transcript word starts are not in order")
        k3, k4, k5 = (launches[c.name] for c in dsk.COUNTERS)
        if launches["power_mel_log"] != 1 or launches["flash_attention_fwd"] != 32:
            raise AssertionError(f"transcribe launches {launches}: expected K1=1, K2=32 for one 2-window encode")
        if not (k3 == k4 == k5 and k3 > 0 and k3 % 32 == 0):
            raise AssertionError(f"transcribe launches {launches}: K3-K5 did not run 32 times per step")
    model.config = config
    wm.encode_mel_chunks, word_timing.word_timings_from_matrix = encode, word_timings
    return {"launches": main_launches, "latency": results}


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


def _train_head(config, n_classes: int = 8) -> dict:
    """bench.py's seeded 2d → 300 → 8 head (``_bench_train``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return {
        "w1": torch.from_numpy((rng.standard_normal((2 * config.d_model, 300)) * 0.02).astype(np.float32)),
        "b1": torch.zeros(300),
        "w2": torch.from_numpy((rng.standard_normal((300, n_classes)) * 0.02).astype(np.float32)),
        "b2": torch.zeros(n_classes),
    }


#: Gradients the 2-layer train check holds to the CPU: q and k reach theirs only
#: through K2-bwd's dQ and dK, v through dV.
TRAIN_CHECK_GRADS = (
    "encoder.conv1.weight",
    "encoder.layers.0.attn.q.weight",
    "encoder.layers.0.attn.k.weight",
    "encoder.layers.1.attn.v.weight",
    "encoder.layers.1.mlp_in.weight",
    "head.w1",
)


def _train_check() -> dict:
    """2-layer full-width train step: loss and named gradients, card (bf16, kernels) against CPU (float32)."""
    import numpy as np
    import torch

    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.parallel import train_step as ts

    config = wm.WhisperConfig(encoder_layers=2)
    state = wm.random_whisper_encoder_state(config, seed=1, device="cpu")
    rng = np.random.default_rng(3)
    waves = torch.from_numpy((0.1 * rng.standard_normal((2, wm.CHUNK_SAMPLES))).astype(np.float32))
    labels = torch.tensor([1, 6])
    readings = {}
    for name, device, dtype in (("cpu", torch.device("cpu"), torch.float32),
                                ("card", torch.device("cuda"), torch.bfloat16)):
        encoder = wm.build_trainable_whisper_encoder(config, state, device=device, compute_dtype=dtype,
                                                     remat=True, remat_policy="dots")
        head = {key: value.to(device).requires_grad_() for key, value in _train_head(config).items()}
        params = ts.train_parameters(encoder, head)
        loss = ts.encoder_classifier_loss(encoder, head, waves.to(device), labels.to(device))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        readings[name] = (loss.item(), {key: grads[key].float().cpu() for key in TRAIN_CHECK_GRADS})
        del encoder, head, params, grads
    (cpu_loss, cpu_grads), (card_loss, card_grads) = readings["cpu"], readings["card"]
    return {
        "loss_cpu": cpu_loss,
        "loss_card": card_loss,
        "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
        "grad_rel_l2": {key: rel_l2(card_grads[key], cpu_grads[key]) for key in TRAIN_CHECK_GRADS},
        "grad_norm_card": {key: card_grads[key].norm().item() for key in TRAIN_CHECK_GRADS},
    }


class _GcClock:
    """Host seconds spent in Python's garbage collector while entered, and the collections."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.collections = 0
        self._started = 0.0

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._started = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._started
            self.collections += 1

    def __enter__(self) -> "_GcClock":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)


def _split_step(encoder, optimizer, head, opt_state, wave, label) -> dict:
    """One train step as ``_train_update`` runs it, timed in parts (ms, host clock)."""
    import torch

    from ser_tpu_torch.parallel import train_step as ts

    valid = torch.full(label.shape, wave.shape[-1], dtype=torch.int32, device=wave.device)
    params = ts.train_parameters(encoder, head)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = ts.encoder_classifier_loss(encoder, head, wave, label, valid)
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    optimizer.apply(params, dict(zip(params, grads)), opt_state)
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return {
        "forward_enqueue_ms": (t1 - t0) * 1e3,
        "loss_and_grads_ms": (t2 - t0) * 1e3,
        "optimizer_enqueue_ms": (t3 - t2) * 1e3,
        "optimizer_ms": (t4 - t2) * 1e3,
        "step_ms": (t4 - t0) * 1e3,
    }


def phase_train() -> dict:
    import numpy as np
    import torch

    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.ops import log_mel
    from ser_tpu_torch.parallel import optim
    from ser_tpu_torch.parallel import train_step as ts

    # bench.py's train lane (_bench_train): large-v3, batch 4 x 30 s, bf16
    # compute on float32 master weights, per-block remat "dots",
    # adafactor(1e-4), K = 3 steps per call.
    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    batch, k_steps = 4, 3
    held_before = torch.cuda.memory_allocated()  # by earlier phases; not the train step's
    started = time.perf_counter()
    state = wm.random_whisper_encoder_state(config, seed=0, device=cuda)
    encoder = wm.build_trainable_whisper_encoder(config, state, device=cuda, compute_dtype=torch.bfloat16,
                                                 remat=True, remat_policy="dots")
    del state
    place, run_steps, optimizer = ts.make_sharded_train_loop(encoder, cuda, optim.adafactor(1e-4))
    rng = np.random.default_rng(0)
    waves = torch.from_numpy((0.1 * rng.standard_normal((k_steps, batch, wm.CHUNK_SAMPLES))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 8, size=(k_steps, batch)).astype(np.int32))
    head, waves, labels = place(_train_head(config), waves, labels)
    opt_state = ts.place_optimizer_state(cuda, optimizer.init(ts.train_parameters(encoder, head)))
    torch.cuda.synchronize()
    say("train-build", seconds=f"{time.perf_counter() - started:.2f}",
        params_m=f"{sum(p.numel() for p in encoder.parameters()) / 1e6:.1f}",
        param_dtype=str(encoder.conv1.weight.dtype), compute_dtype="torch.bfloat16", remat="dots",
        optimizer=optimizer.name)

    head, opt_state, warm_losses = run_steps(head, opt_state, waves, labels)  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    watched = ("layers.0.attn.q.weight", "layers.31.mlp_out.weight", "conv1.weight")
    params = dict(encoder.named_parameters())
    before = {name: params[name].detach().clone() for name in watched}
    before["head.w2"] = head["w2"].detach().clone()

    counters = (log_mel.COUNTER, attention.COUNTER, attention.BWD_COUNTER)
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    with _GcClock() as gc_clock:
        head, opt_state, losses = run_steps(head, opt_state, waves, labels)
        losses = losses.cpu()
    elapsed = time.perf_counter() - started
    launches = {c.name: c.launches for c in counters}
    peak_gb = (torch.cuda.max_memory_allocated() - held_before) / 1e9

    after = {name: params[name].detach() for name in watched}
    after["head.w2"] = head["w2"].detach()
    moved = {name: (after[name] - before[name]).abs().max().item() for name in before}
    finite = bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all()) for t in after.values())
    per_step = {name: count / k_steps for name, count in launches.items()}
    ms_per_step = elapsed / k_steps * 1e3
    audio_s_per_s = k_steps * batch * 30.0 / elapsed
    # 3x the encoder forward (bench.py:64-68's count) plus the attention
    # products that the "dots" recompute runs again (2 x 2·B·T²·d per layer).
    flops_per_step = 3 * _encoder_flops(config, batch) + 2 * 2.0 * batch * 1500 * 1500 * config.d_model * config.encoder_layers
    mfu = flops_per_step / (elapsed / k_steps) / PEAK_BF16_FLOPS
    say("train", batch=batch, steps=k_steps, seconds=f"{elapsed:.4f}", ms_per_step=f"{ms_per_step:.2f}",
        audio_s_per_s=f"{audio_s_per_s:.1f}", mfu=f"{mfu:.4f}", tflop_per_step=f"{flops_per_step / 1e12:.3f}",
        peak_mem_gb=f"{peak_gb:.2f}", held_by_earlier_phases_gb=f"{held_before / 1e9:.2f}",
        launches=json.dumps(launches), launches_per_step=json.dumps(per_step),
        losses=json.dumps([round(x, 6) for x in losses.tolist()]),
        warm_losses=json.dumps([round(x, 6) for x in warm_losses.cpu().tolist()]),
        param_max_abs_change=json.dumps({n: f"{m:.3g}" for n, m in moved.items()}))
    if not finite:
        raise AssertionError(f"train step gave non-finite losses or parameters: {losses.tolist()}")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"parameters did not move: {moved}")
    expected = {"power_mel_log": 1, "flash_attention_fwd": 2 * config.encoder_layers,
                "flash_attention_bwd": config.encoder_layers}
    if per_step != expected:
        raise AssertionError(f"launches per step {per_step}, expected {expected}")

    # One more step, split on the host clock: loss + gradients, then the
    # optimizer (its host enqueue and its end on the card), and the host time
    # Python's garbage collector took during the timed steps.
    split = _split_step(encoder, optimizer, head, opt_state, waves[0], labels[0])
    say("train-split", gc_ms_per_step=f"{gc_clock.seconds / k_steps * 1e3:.2f}",
        gc_collections=gc_clock.collections, host_us_per_op=f"{host_us_per_op():.2f}",
        **{key: f"{value:.2f}" for key, value in split.items()})

    one_step = (waves[:1], labels[:1])
    state_box = [head, opt_state]

    def train_one_step():
        state_box[0], state_box[1], _ = run_steps(state_box[0], state_box[1], *one_step)

    breakdown = _profile(train_one_step, "train")
    say("train-profile", detail=breakdown)
    del encoder, params, head, opt_state, state_box, before, after
    torch.cuda.empty_cache()

    check = _train_check()
    worst = max(check["grad_rel_l2"].values())
    say("train-check", layers=2, d_model=config.d_model, batch=2, loss_cpu=f"{check['loss_cpu']:.6f}",
        loss_card=f"{check['loss_card']:.6f}", loss_rel_err=f"{check['loss_rel_err']:.3g}",
        loss_bound=TRAIN_CHECK_LOSS_BOUND, grad_rel_l2=json.dumps({k: f"{v:.5f}" for k, v in check["grad_rel_l2"].items()}),
        grad_bound=TRAIN_CHECK_GRAD_REL_L2_BOUND,
        grad_norm_card=json.dumps({k: f"{v:.4g}" for k, v in check["grad_norm_card"].items()}))
    if not check["loss_rel_err"] <= TRAIN_CHECK_LOSS_BOUND or not worst <= TRAIN_CHECK_GRAD_REL_L2_BOUND:
        raise AssertionError(f"card train step disagrees with the CPU: {check}")
    if not all(norm > 0 for norm in check["grad_norm_card"].values()):
        raise AssertionError(f"a gradient on the card is zero: {check['grad_norm_card']}")
    return {"launches": launches, "launches_per_step": per_step, "ms_per_step": ms_per_step}


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
        phase = "K2-bwd"
        k2_bwd = phase_k2_bwd()
        phase = "K3"
        k3 = phase_k3()
        phase = "K4"
        k4 = phase_k4()
        phase = "K5"
        k5 = phase_k5()
        phase = "grad-guard"
        phase_grad_guard()
        phase = "encoder"
        per_encode = phase_encoder()
        phase = "decode"
        decode = phase_decode()
        phase = "transcribe"
        transcribe = phase_transcribe()
        phase = "infer"
        launches = phase_infer()
        phase = "train"
        train = phase_train()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1

    # K1 and K2: launches of the three api.infer requests; K3-K5: of the first
    # (full-budget) transcribe_words call. Each path's counts are set to 0 just
    # before it and read just after.
    k1.update(launches=launches["power_mel_log"], launches_per_encode=per_encode["k1_per_encode"])
    k2.update(launches=launches["flash_attention_fwd"], launches_per_encode=per_encode["k2_per_encode"])
    for kernel in (k3, k4, k5):
        kernel.update(launches=transcribe["launches"][kernel["name"]],
                      launches_per_decode=decode["launches_per_decode"][kernel["name"]],
                      decode_steps=decode["steps"])
    # K2-bwd: launches of the timed train call (3 steps).
    k2_bwd.update(launches=train["launches"]["flash_attention_bwd"],
                  launches_per_step=train["launches_per_step"]["flash_attention_bwd"])
    print(json.dumps({"kernels": [k1, k2, k2_bwd, k3, k4, k5]}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
