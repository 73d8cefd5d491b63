#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one CUDA card and checks its kernels.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ser_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel), then, one phase per line:

1. environment: torch/CUDA versions, the card's name and power limit, build time;
2. K1 at the main path's shapes: its spectrum form (power → mel → log10)
   against its plain version on the same spectrum, with a planted fault its
   limit must catch (the power's imaginary half dropped); its fused form
   (waveform → raw log-mel, the framing and the 3×TF32 DFT inside the kernel)
   on (8, 480000) noise and a 440 Hz tone: the normalized log-mel against the
   plain version (TF32 off), the raw log-mel against float64 beside the plain
   route's own error, a planted one-TF32-pass fault, the same bits on two
   runs; then at shapes the main path does not give it (a (3, 16077) window
   at 80 mels, a waveform off 16-byte alignment); with its time, the old
   route's (matmul STFT + spectrum form), ``torch.stft`` + spectrum form's
   and the plain version's, each read five times in turns (median, lowest,
   highest), and its bound; then ``resample``: the port's own kernel
   ``resample_rows`` (no TPU counterpart) at a 600 s 48 kHz file into
   Whisper's 20 windows, ``mixed-files``' largest bucket batch and the file
   at 44.1 kHz, against its plain version (float64 sums) with a planted
   one-sample-late row, with its time, the plain version's, its byte bound,
   torch's ``conv1d`` route to the same rows where the ratio is 1/down, and
   the host's ``resample_poly`` over the same clips; the kernel at 1/1 and
   at 16000/7919 (the form that reads device memory), its launch counter,
   the wrapper's refusals, and a traced ``infer_many`` of two 48 kHz clips
   whose rows are made on the card (``resample_card_samples``, no
   ``resample_host_samples``, spans ``ser.resample``, ``ser.encode``,
   ``ser.fetch`` in turn);
3. K2 (flash attention) at the encoder's shapes, with and without a key mask,
   and at T = 1409 (one valid row in the last 128-row tile), against its plain
   version in float32, with SDPA's time as the yardstick; K2-f32 (its float32
   form) against the float32 plain version (TF32 off) at the medium profile's
   (8, 1499, 16, 64) with a ragged key mask, at Whisper's (8, 1500, 20, 64)
   and at T = 1409, with two planted faults its limit must catch (operands
   rounded to TF32, masked keys let into the softmax), and at the training
   encode's 4 s bucket (32 clips of 3 s, and one) with the masked-key leak
   planted; ``K2-medium``: masked bf16 K2 at the medium profile's 30 s and
   15 s buckets and the training encode's 4 s bucket (batch 32 and 1) against
   its plain version and its unmasked time; then K2-bwd (its
   backward: Δ, dK/dV and dQ kernels) at the training step's shapes and at
   T = 1409: K2's log-sum-exp against ``torch.logsumexp``, dq, dk and dv
   against the plain backward in float32 (with two planted faults its limit
   must catch), dq bit for bit on two runs, and its time beside the plain
   version's, SDPA's backward and its bound. Each line gives the achieved
   TFLOP/s, the share of the bound and the time over SDPA's;
4. K3 (LayerNorm → fused QKV), K4 (cached self-attention + out-projection +
   residual, with poisoned future cache slots at positions 0, 100, 447 and on
   both sides of a chunk boundary of its cluster split) and K5 (the
   cross-attention block and its float32 weights, also at S = 1000, where the
   last CTA's chunk is short) at large-v3's decode shapes with 2 rows, each
   against its plain version in float32, each with a planted fault its limit
   must catch, K4 and K5 the same bits on two runs, and with its time, the
   plain version's, the unfused PyTorch route's and its bound; then
   ``grad-guard``: K1 (both forms) and K3, which have no backward, refuse a
   CUDA input that requires grad;
5. the large-v3 encoder at full width (32 layers, seeded random weights, bf16)
   on 8 windows: audio-seconds per second, MFU, launches per encode, and a
   2-layer full-width card-vs-CPU check of the same weights;
6. the full-width large-v3 greedy KV-cache decode (seeded random weights,
   bf16) over the encoder states of 2 windows, 448-token budget, through the
   kernels and through PyTorch ops: ms per step, tokens per second, launches,
   the two routes' logits over the positions before their first differing
   token, a device-time profile of each (busy share: the union of the
   device events' intervals over the wall time), and a 2-layer card-vs-CPU
   check;
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
   CPU;
10. ``medium-encoder``: the XLS-R 300M encoder at full width (24 layers,
    seeded random weights, bf16) on 8 chunks of 30 s: audio-seconds per
    second, MFU with its FLOP count by part, launches per encode, device
    time by kernel group, and a 2-layer full-width check of the card in bf16
    and in float32 against float32 on the CPU; then ``medium-infer``:
    ``api.infer(profile="medium")`` on three clips cold and warm, one request
    with ``SER_DEVICE_POOLING=1`` (its pooled features held to the host
    pooling's), one with ``SER_TORCH_DTYPE=float32`` and one whose first bf16
    encode a planted wrapper makes non-finite (the retry must run in float32
    through K2-f32);
11. ``research-encoder``: a full-width emotion2vec ``model.pt`` (FunASR layout,
    bf16, seeded weights) staged under a ModelScope root and converted by the
    port's converter, its inferred config checked against the staged layout,
    8 chunks of 30 s encoded (audio-seconds per second, MFU with the
    positional stack as its own part, 24 K2 launches per encode, device time
    by kernel group), and a 2-layer card-vs-CPU check of the converted
    weights in bf16 and in float32; then ``research-infer``:
    ``api.infer(profile="accurate-research")`` on three clips cold and warm
    behind the opened restricted-backend gate, one request with the gate
    shut (refused), and one whose first bf16 encode is made non-finite (the
    retry through K2-f32);
12. ``fast-infer``: ``api.infer(profile="fast")`` on three clips cold and
    warm, the handcrafted features computed on the card, its device time by
    group, and the card's frame features of the 45 s clip held to the CPU
    route's at the golden tolerances family by family, with a planted fault
    (frame means over padded columns) they must catch, and the same features
    with TF32 products for information;
13. ``beam``: ``transcribe_words`` by beam search (5 beams, 10 rows) on the
    60 s clip at the 96-token budget, cold and warm, with its spans (encode,
    beam decode, the teacher-forced alignment pass, the alignment reduction,
    DTW), ms per beam step and launches (K1 1, K2 32, K3-K5 0); beam-1
    against the unfused greedy decode token for token; the teacher-forced
    capture against the greedy loop's own; and the beamed step (2-layer
    full-width decoder) on the card against float32 on the CPU, with a
    planted fault (every row reading window 0's cross K/V) it must catch;
14. ``int8-decode``: ``torch._int_mm`` on the card against the CPU's exact
    int32 product at 2 and 10 rows for the QKV and the padded vocabulary
    projections (and which operand layouts and shapes the card accepts), the
    W8A8 step's logits against the bf16 step's over 8 positions (correlation
    above 0.99; a planted dequant without the activation scale must fall
    below), and ``transcribe_words`` on the int8 stream at the 96-token budget
    (no K3-K5 launch);
15. ``int8-encoder``: the W8A8 encoder on 8 windows (ms per encode,
    audio-s/s, TOPS on its product operations), its states against the bf16
    encoder's (cosine at least 0.995; the planted fault must fall below), and
    ``api.infer(profile="accurate")`` with ``SER_TORCH_DTYPE=int8`` on three
    clips (K1 1 and K2 32 per encode);
16. ``k2-remeasure``: K2 and SDPA on the same (8, 1500, 20, 64) bf16 tensors,
    five readings each in turns (median, lowest, highest), with the SM clock
    before and after;
17. ``boundary``: ``api.infer(profile="accurate")`` (large-v3, seeded, bf16)
    on a 45 s clip through the retry ladder: a plain request; a transient
    error after the first encode (the retry gives the plain segments, K1 and
    K2 launch for both attempts); a real ``torch.cuda.OutOfMemoryError``
    (classified hard OOM, retried once, raised as ``TransientInferenceError``);
    a compute timeout with no timeout retry (``InferenceTimeoutError``); a
    spawned worker (``SER_ACCURATE_PROCESS_ISOLATION=1``: the plain segments,
    its cold wall time); two threads at once (the single flight: no two
    encodes overlap); each case's wall time and attempts;
18. ``fast-train``: a synthetic corpus (8 emotions × 4 actors × 6 clips of 3 s
    at 48 kHz, RAVDESS names, two corrupt headers admitted by
    ``SER_MAX_FAILED_FILE_RATIO``): ``loader.load_data`` with the features on
    the card, held to the CPU route's at the golden tolerances; then
    ``api.train(profile="fast")`` (readiness quarantines the two corrupt
    files, the fast backend's smoke, the fit, the artifact): its head
    (193 → 300 → 8, batch 256, 500 epochs at most) fitted on the card, held
    to the same fit on the CPU from the same seeded layers and permutations
    (the same epochs, losses at rtol 1e-4, the same test predictions); test
    accuracy at least 0.9, and below 0.5 with the labels shuffled (a planted
    fault); the artifact served by ``api.infer(profile="fast")`` on a
    held-out clip; ms per epoch, epochs and the features' audio-seconds per
    second;
19. ``accurate-train``: ``api.train(profile="accurate")`` with large-v3 at full
    width (seeded random weights, bf16) on a synthetic corpus (8 emotions × 4
    actors × 3 clips of 3 s at 48 kHz, two corrupt files): readiness (the two
    quarantined), the smoke (16 stratified probes), the encode (one 30 s
    window a clip: one K1 and 32 K2 launches per window, the smoke's
    included), the head's fit on the card; readiness and smoke seconds, the
    encode's audio-seconds per second, windows, epochs and ms per epoch,
    the run's wall seconds by cause (readiness, smoke, encode, reads and the
    failed reads' retry sleeps, the embedding cache's loads and stores,
    pooling, noise controls, split, fit, artifact, the rest),
    window and grouped UAR, test accuracy (at least
    ``ACCURATE_TRAIN_ACCURACY_BAR``; the same rows with shuffled labels below
    0.5); a second run on the same corpus reads every clip from the embedding
    cache (only the smoke encodes) and gives the same rows bit for bit and the
    same metrics; two clips' pooled rows through K1 and K2 against both
    patched to their plain versions on the card (``ENCODER_REL_L2_BOUND``);
    the artifact served by ``api.infer(profile="accurate")`` on a held-out
    clip;
20. ``medium-train``: ``api.train(profile="medium")`` with XLS-R 300M at full
    width on the same corpus: the masked K2 launches (24 per batched encode),
    the same numbers and checks (the bar ``MEDIUM_TRAIN_ACCURACY_BAR``), a
    cached rerun, the pooled rows of one training batch (32 clips in the 4 s
    bucket) through masked K2 against the plain attention patched in on the
    card (``ENCODER_REL_L2_BOUND``, no launch in the plain run, a planted leak
    of the padded frames above the bound), the artifact served by
    ``api.infer(profile="medium")`` (its frames the head's own labels), and a
    run whose first training encode a planted wrapper makes non-finite: the
    retry and every later encode run in float32 through K2-f32, the backend
    stays float32, and the same batch's rows through K2-f32 are held against
    the float32 plain attention (``TRAIN_F32_ROW_REL_L2_BOUND``);
21. ``research-train``: ``api.train(profile="accurate-research")`` with the
    emotion2vec layout at full width on the same corpus: refused in readiness
    while the license gate is shut (no kernel launched), then trained behind
    the opened gate (masked K2 launches, the same numbers, the bar, the
    planted fault and the row check of ``medium-train``) and served by
    ``api.infer`` (its frames the trained head's own labels for the held-out
    clip);
22. ``dist-train``: the train lane of phase 9 through the distributed layer:
    ``initialize_distributed()`` from ``SER_DIST_*`` with one process (an
    NCCL group of 1), ``build_mesh`` (1x1) and
    ``make_sharded_train_loop(encoder, mesh, ...)``: its 3 losses and every
    updated parameter against the one-device loop from the same start (the
    same bits), with a planted fault (one gradient doubled at the second
    step) the limit must catch; launches of K1, K2 and K2-bwd equal to phase
    9's; ms per step beside the one-device loop's, timed in turns, and phase
    9's (the collective path's cost), and the data-axis mean's own time; a
    checkpoint saved and restored at the mesh, then one more step, against
    the uninterrupted step;
23. ``batch-infer``: ``infer_many`` over 12 WAVs (four each of 10, 45 and
    75 s) and a corrupt file under that group (the gather path): accurate at
    full width (K1 once and K2 32 times per clip encode) and medium (XLS-R
    300M layout, ``chunked_encode_many``: masked K2 24 times per cross-clip
    batch), each row against ``api.infer`` on the same file, the corrupt
    file's error in its row, files and audio-seconds per second;
24. ``separate``: htdemucs at its published widths (48 channels, depth 4,
    nfft 4096, bottom 512, 5 transformer layers of 8 heads; seeded synthetic
    weights staged as ``.npz``) and the spectrogram U-Net at its defaults:
    one segment each through the card's float32 forward against a float64
    forward of the same module on the card (``SEPARATE_DEMUCS_REL_L2_BOUND``,
    ``SEPARATE_UNET_REL_L2_BOUND``; planted faults: htdemucs's inverse STFT
    reading the DC bin's imaginary part, one LayerScale x1.01, one U-Net
    GroupNorm scale x1.01); then ``WhisperTranscriber(use_demucs=True)
    .transcribe`` of a 60 s music-like WAV through
    ``SER_SEPARATION_MODEL_PATH``, once per separator, cold and warm, with the
    full-width large-v3 of phase ``transcribe`` (96 tokens): spans of the
    separation, the spectral gate and the transcribe, ms per dispatch and
    dispatches, the host's share, peak memory, K1-K5 launches of the cold
    call; and the timeline of the demucs run's words and a warm
    ``api.infer(profile="accurate")`` written as CSV, SRT, VTT and ASS and
    read back;
25. ``cli``: the command line, ``ser_tpu_torch.__main__.main(argv)`` in this process, at large-v3's full
    width (seeded random weights, bf16, the card's default settings): ``configure`` and ``data consents``;
    ``data prepare ravdess --skip-download`` on 32 RAVDESS-named 3 s clips (4 actors x 8 emotions), then
    ``data registry --show --format json``, ``data health``, ``data catalog --format json`` and ``data
    audit --lenient`` (the manifest read back); ``--train --profile accurate --dry-run`` (no launch), then
    ``--train --profile accurate`` (K1 once and K2 32 times for each of the smoke's 16 and the 32 training
    encodes); ``--file`` on a 45 s clip with the trained head, cold, then warm with ``--save_transcript``
    and ``--subtitle-output`` (K1 1 and K2 32 each; the segments checked, the ``Timeline CSV:`` and
    ``Subtitles:`` files read back); ``--train --repair`` with network repairs off (the smoke's 16
    encodes) and ``doctor --format json`` (no blocking finding, the card named); then ``python -m
    ser_tpu_torch --file ...`` in a subprocess (exit 0, the timeline printed). Every exit code must be 0,
    and the phase must end within ``CLI_WALL_LIMIT_S``. Its ``--file`` requests pass ``--no-transcript``;
    phase 26 drives the transcript-on request;
26. ``transcript-infer``: the default request, transcript on, with the card's default settings and no
    ``SER_ALLOW_RANDOM_INIT``: a seeded large-v3 checkpoint staged at its full widths as Hugging Face
    publishes one (``model.safetensors`` in F16, ``config.json``, ``generation_config.json``, tokenizer
    files in large-v3's layout: 50257 byte-level tokens, 1609 added tokens), read by the emotion lane and
    by the transcript lane through ``from_pretrained_dir`` and the port's own tokenizer; its decoder spells
    a repeated phrase, so every window runs the whole temperature-retry ladder. On one 20 s clip:
    ``api.infer(clip, profile="accurate")`` cold and warm, the same with the transcript off (the same
    emotion segments), ``from_pretrained_dir`` with its defaults (the card, bf16) and
    ``transcribe_words`` (the same words and times as the request), the CLI's ``--file`` with
    ``--save_transcript`` and an SRT in the process (the CSV's speech rows and the cues read back), a
    request with htdemucs before the transcript (``WHISPER_DEMUCS=1``, ``SER_SEPARATION_MODEL_PATH``),
    ``doctor`` (the transcriber's assets found, no blocking finding), ``--calibrate-transcription-runtime``
    on one RAVDESS-named clip, and ``python -m ser_tpu_torch --file ...`` in a subprocess (the same SRT).
    Each request prints its wall seconds, the pipeline's phase timings, its decodes per window, K1-K5
    launches and peak memory beside the card's name and power limit; K3 = K4 = K5 = 32 per decode step,
    every word in its window's decode, and the phase within ``TRANSCRIPT_INFER_WALL_LIMIT_S``;
27. ``device-defaults``: with ``SER_TORCH_DEVICE`` unset for the phase, each
    of the eight public constructors that took a CPU default before (the
    head's ``TorchMLPClassifier(...)`` and ``from_state``,
    ``load_model_artifact``, the three ``random_*_state``,
    ``restore_train_state`` with and without a 1×1 mesh,
    ``init_multitask_loss_params``) called with no ``device`` or
    ``map_location`` at tiny configs: every tensor on the card, and each
    seeded default draw the same bits as its ``device=cuda`` draw;
28. ``operator``: the operator's path with the card's settings
    (``SER_TORCH_DEVICE`` at its default): the doctor (with its environment
    findings) and ``api.run_startup_preflight`` (no blocking finding; the
    accelerator finding names the card; the native audio library built and
    taken by ``read_audio_file``); ``api.load_profile("accurate")`` passes and
    ``load_profile("accurate-research")`` with its license gate shut raises
    ``UnsupportedProfileError``, which the command runner maps to exit 2;
    then, inside ``device_trace``, ``benchmark_fast_predict(runs=5)`` on a
    10 s clip (mean, median, p95) and
    ``run_quality_gate_workflow(candidate="accurate", folds=4)`` on 16
    RAVDESS-named 3 s clips (4 classes, 4 speakers) with the full-width
    large-v3 encoder (seeded random weights): exit 0, the report read back
    with the decision's verdict, ``candidate_stability`` present (a swallowed
    error of the stability pass fails the phase), K1 and K2 launched once and
    32 times for each encoded window and stability request, and the trace
    naming both kernels' symbols.

Phases 5-28 set the launch counts of the kernels they run to 0 just before
their run and read them just after; K1's two forms count apart, and the
main path must launch the fused form once per encode and the spectrum form
never.

It prints the run's wall time, a ``kernels`` JSON line, the card's name and
power limit, and, as its last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line, as does a machine with no CUDA device or a directory
without the port.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pickle
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# K1, max abs error against its plain version (the JAX package's pin). The
# spectrum form: the raw log10-mel from the same spectrum, float32 sums in
# another order. The fused form forms the DFT itself, three TF32 products a
# product, against the plain version's float32 matmul: each sits 3-5e-5 from
# float64 on noise in the raw domain, and far more on a tone's deep bins, which
# Whisper's max-8 floor then clamps away (a CPU emulation, one 30 s window). So
# the fused form is held on the normalized log-mel, what the encoder reads; its
# raw error against a float64 computation may be at most twice the plain
# float32 route's own. One TF32 pass misses the normalized limit 400-1000x.
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
# K2-f32, max abs error against the float32 plain version on the same float32
# q, k, v (TF32 off, which the phase asserts): float32 sums in another order.
# The limit is the port's float32 attention pin (tests/test_torch_attention.py).
# A CPU emulation at T = 1499 put one TF32 pass over the operands at 1.2-1.4e-4
# max abs, about 7x the limit; phase K2-f32 checks that the limit catches that
# fault and a leak of the masked keys into the softmax.
K2_F32_TOLERANCE = 2e-5
# The medium profile's attention: XLS-R 300M's 16 heads of 64 over the 1499
# frames of a 30 s bucket, 8 chunks a call; its 15 s bucket has 749 frames.
MEDIUM_ATTENTION = (8, 1499, 16, 64)
MEDIUM_HALF_BUCKET_FRAMES = 749
# The medium and research training encodes: 3 s clips in the 4 s bucket (199
# frames, 149 of them valid), 32 clips a batch; each smoke probe one clip.
TRAIN_BUCKET_FRAMES, TRAIN_CLIP_FRAMES, TRAIN_ENCODE_BATCH = 199, 149, 32
# Pooled training rows of a float32 encode (XLS-R 300M, 24 layers) with K2-f32
# against the float32 plain attention on the card: only the order of the sums
# differs. Measured on an H100: 3.4e-7, and 3.9e-5 with the operands rounded
# to TF32 (a planted fault); the limit sits between, about 30x the reading.
# A leak of the padded frames into the keys (0.29) must land above it too, and
# above ENCODER_REL_L2_BOUND in bf16.
TRAIN_F32_ROW_REL_L2_BOUND = 1e-5
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
# Full-width XLS-R 300M, 2 layers, one 30 s chunk with 20 s valid: the card
# against float32 on the CPU, same weights. bf16: the transformer's products
# and attention in bf16 (the front end, LayerNorms and residual stream stay
# float32), a limit about 3x the Whisper encoder's reading (0.0056), which has
# bf16 everywhere. float32: every product float32 on the card too (TF32 off,
# K2-f32), so only the order of the sums differs: the repo's float32 encoder
# pin, atol 1e-4 on unit-scale activations.
MEDIUM_BF16_REL_L2_BOUND = 2e-2
MEDIUM_F32_MAX_ABS_BOUND = 1e-4
# Device pooling against host pooling: float32 on the card against float64 on
# the host (tests/suites/unit/pool/test_device_pooling.py's ceiling), per
# window relative to its largest feature.
DEVICE_POOLING_REL_BOUND = 1e-5
MEDIUM_MODEL_ID = "facebook/wav2vec2-xls-r-300m"
# The accurate-research profile: emotion2vec_plus_large, data2vec 2.0 audio at
# its published widths (d 1024, 16 heads, FFN 4096, 24 AltBlocks; fairseq's
# conv_pos_width 95 over conv_pos_depth 5 (kernel 19), conv_pos_groups 16).
# The prenet/trunk split (8 + 16) is assumed: the converter flattens both
# into one stack, so only the total shows in the model.
RESEARCH_MODEL_ID = "iic/emotion2vec_plus_large"
RESEARCH_PRENET_BLOCKS = 8
RESEARCH_BLOCKS = 24
RESEARCH_POS_DEPTH, RESEARCH_POS_KERNEL, RESEARCH_POS_GROUPS = 5, 19, 16
# The fast profile's features, card against the CPU route on the same clip:
# the golden tolerances of tests/suites/unit/ops/test_dsp_golden_fixtures.py,
# rtol 2e-3 and per family an atol times max(1, |CPU value|).
FAST_RTOL = 2e-3
FAST_FAMILIES = {
    "mfcc": (slice(0, 40), 2e-3),
    "chroma": (slice(40, 52), 5e-3),
    "mel": (slice(52, 180), 2e-4),
    "contrast": (slice(180, 187), 2e-3),
    "tonnetz": (slice(187, 193), 5e-3),
}
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
# The transcript lane's beam and int8 phases: the 96-token budget (bench.py:469-475).
TRANSCRIPT_BUDGET = 96
# Positions of the decode phase's traced greedy loops, as the beam and int8 profiles trace: the
# profiler's own processing of the trace, on the host, sets their cost, and it grows with the positions.
DECODE_PROFILE_BUDGET = 16
# alignment_forward's capture (teacher-forced, full causal attention) over the
# greedy winners against the unfused greedy loop's own capture, bf16 at full
# width, 2 windows, the 32 default alignment heads: rel L2 over the valid rows.
# The two sum in another order in bf16: 0.00281 measured on an H100 (max abs
# 2.4e-5), and the limit is about 3.5x that.
ALIGN_CAPTURE_REL_L2_BOUND = 1e-2
# The W8A8 decode step's logits against the bf16 unfused step's, per row and
# position: the JAX package's pin (tests/suites/unit/models/test_decode_int8.py).
INT8_LOGITS_CORRELATION_BOUND = 0.99
# The int8 encoder's states against the bf16 encoder's, same weights: the JAX
# package's pin (tests/suites/unit/models/test_quant_dense.py:101-119).
INT8_ENCODER_COSINE_BOUND = 0.995
# Bytes of weight copies cycled through when timing a decode-step kernel: the
# decode reads 32 layers' weights per step, far more than the 50 MB L2, so
# each call finds its weights in device memory, not in L2.
ROTATION_BYTES = 160e6

# Test accuracy of the heads that api.train fits on seeded random encoders over the synthetic corpus
# (8 tone classes, speaker-disjoint split): set before the first run on the card. The planted fault
# (the same rows with shuffled labels) must score below 0.5 (chance is 1/8). The accurate bar is the
# fast head's; medium's is lower: a 2-layer random XLS-R on the CPU read 0.889 on this corpus.
ACCURATE_TRAIN_ACCURACY_BAR = 0.9
MEDIUM_TRAIN_ACCURACY_BAR = 0.75

RAVDESS_LABELS = ["angry", "calm", "disgust", "fearful", "happy", "neutral", "sad", "surprised"]

# dist-train: the mesh loop (an NCCL group of 1, a 1x1 mesh) against the one-device loop from the same
# start. The same kernels in the same order on the same inputs, cuDNN's convolutions held to their
# deterministic algorithms in both, and a data-axis all-reduce over one rank (a copy): the same bits,
# so the limit on losses and parameters is 0. The planted fault (one gradient doubled at the second step)
# must land above it, as must a restored checkpoint's next step parted from the uninterrupted one.
DIST_TRAIN_ATOL = 0.0
# batch-infer: four clips each of 10, 45 and 75 s (1, 2 and 3 windows of 30 s; 15 s chunks and 30 s
# chunks for medium). Accurate: each clip encodes as api.infer encodes it (its windows in one batch), so
# its rows are expected bit for bit; the limit allows 1e-6 of probability. Medium: infer_many batches
# chunks across clips by bucket (a 45 s clip's 15 s tail in the 15 s bucket, where api.infer pads it to
# 30 s with its first chunk), so its bf16 products run at other shapes: a limit of 1e-2 on probabilities
# (the bf16 encoder's 2e-2 relative error against float32 is the wider bound), and frame labels held
# wherever api.infer's top-two margin is wider than twice that.
BATCH_CLIP_SECONDS = (10.0, 45.0, 75.0) * 4
BATCH_ACCURATE_PROB_ATOL = 1e-6
BATCH_MEDIUM_PROB_ATOL = 1e-2
# separate: one segment's vocals from the card's float32 forward against a float64 forward of the same
# module and weights on the card, relative L2, for htdemucs (7.8 s at 44.1 kHz) and the U-Net (10 s at
# 16 kHz). TF32 is off in both, so only the order and the precision of the sums differ. The seeded random
# htdemucs amplifies its own rounding about 20x: at its published widths float32 read 1.6e-4 from float64
# on the CPU and 3.3e-4 on the card, where it read 1.8e-3 until the inverse STFT zeroed the DC bin's
# imaginary part, which cuFFT's float32 inverse reads (models/demucs_v4.py::_ispec). Planted faults: that
# imaginary part left in (1.8e-3), and one LayerScale vector of the first cross layer x1.01 (0.18); the
# limit sits about 2.4x from the reading and from the first fault. The U-Net at its defaults read 2.3e-7
# on the card and its planted fault (one decoder GroupNorm scale x1.01) 1.7e-3; its limit is about 4x
# its reading.
SEPARATE_DEMUCS_REL_L2_BOUND = 8e-4
SEPARATE_UNET_REL_L2_BOUND = 1e-6
# The transcribed clip of the separate phase: 60 s, two Whisper windows.
SEPARATE_CLIP_SECONDS = 60.0
# operator: the corpus of the quality gate (4 classes x 4 speakers of 3 s at 48 kHz, one 30 s Whisper window a
# clip), the stability requests its workflow sends (its default: the first 6 clips), and the phase's limit.
OPERATOR_CLASSES = 4
OPERATOR_SPEAKERS = 4
OPERATOR_STABILITY_REQUESTS = 6
OPERATOR_WALL_LIMIT_S = 60.0
DEVICE_DEFAULTS_WALL_LIMIT_S = 30.0
# cli: the command line's corpus (RAVDESS's 24 actors x 8 emotions x 2 statements x 2 repetitions cut to
# 4 actors x 8 emotions x 1 clip of 3 s at 48 kHz: one 30 s Whisper window a clip), its --file clip (45 s:
# two windows, one encode), phase infer's warm 45 s request to compare with (PR 9), and the phase's limit.
CLI_ACTORS = 4
CLI_FILE_SECONDS = 45.0
INFER_45S_WARM_S = 0.1154
CLI_WALL_LIMIT_S = 60.0


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


def _held_run_ms(fn, calls: int, host_ms: float) -> float | None:
    """Device ms of ``calls`` calls of ``fn`` enqueued behind a hold of the card, or
    ``None`` if the host took longer to enqueue them than the card slept."""
    import torch

    hold_ms = 2.0 * host_ms * calls + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _hold_card(hold_ms)
    start.record()
    enqueue_started = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = (time.perf_counter() - enqueue_started) * 1e3
    end.record()
    torch.cuda.synchronize()
    return None if enqueue_ms > hold_ms else start.elapsed_time(end)


def cuda_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls.

    The card is held in a sleep while the host enqueues the calls, so that the
    events time the calls back to back on the card and not the host's pace
    (a decode-step kernel takes less time on the card than its launch on the
    host). A plain version of many small ops can fill the card's queue of
    pending launches, which blocks the host until the hold ends: when the host
    took longer to enqueue than the card slept, the calls are timed again in
    held runs of half as many, down to one call a run. Raises if even one call
    outlasts its hold.
    """
    import torch

    started = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - started) * 1e3 / warmup
    per_run = iters
    while True:
        total_ms = 0.0
        for done in range(0, iters, per_run):
            run_ms = _held_run_ms(fn, min(per_run, iters - done), host_ms)
            if run_ms is None:
                break
            total_ms += run_ms
        else:
            return total_ms / iters
        if per_run == 1:
            raise AssertionError(f"one call took the host longer to enqueue than the card's hold of "
                                 f"{2.0 * host_ms + 5.0:.1f} ms")
        per_run = max(1, per_run // 2)


def span_ms(fn, *, iters: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around ``iters`` calls, without a hold.

    For plain versions whose calls take milliseconds and allocate gigabytes:
    a host blocked inside a call (a device allocation) would overrun
    :func:`cuda_ms`'s hold. Such a wait counts here as device time.
    """
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(routes: dict, *, runs: int = 5, iters: int = 20) -> dict[str, dict]:
    """Each route of ``routes`` (name → call) timed ``runs`` times by :func:`cuda_ms`, the
    routes taking turns: by route, the median reading and the lowest and highest."""
    readings = {name: [] for name in routes}
    for _ in range(runs):
        for name, fn in routes.items():
            readings[name].append(cuda_ms(fn, iters=iters))
    return {name: {"ms": statistics.median(values), "min_ms": min(values), "max_ms": max(values)}
            for name, values in readings.items()}


def spread(reading: dict) -> str:
    return f"{reading['ms']:.4f} [{reading['min_ms']:.4f}-{reading['max_ms']:.4f}]"


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


def _k1_spectrum_form(wave, fb, out_frames: int) -> dict:
    """K1's spectrum form (the TPU kernel's boundary) against its plain version on the same spectrum."""
    import torch

    from ser_tpu_torch.ops import log_mel

    batch, n_mels = wave.shape[0], fb.shape[1]
    spec = log_mel.stft(wave, 400, 160).contiguous()  # (8, 3001, 402)
    kernel_out = log_mel.power_mel_log(spec, fb, out_frames)
    plain_out = log_mel.power_mel_log_reference(spec, fb, out_frames)
    torch.cuda.synchronize()
    err = (kernel_out - plain_out).abs().max().item()
    # Planted fault: the power's imaginary half dropped.
    n_bins = fb.shape[0]
    real_only = spec.clone()
    real_only[..., n_bins:] = 0.0
    fault = (log_mel.power_mel_log_reference(real_only, fb, out_frames) - plain_out).abs().max().item()
    del real_only
    ms = cuda_ms(lambda: log_mel.power_mel_log(spec, fb, out_frames))
    plain_ms = cuda_ms(lambda: log_mel.power_mel_log_reference(spec, fb, out_frames))
    bytes_moved = spec.numel() * 4 + fb.numel() * 4 + batch * out_frames * n_mels * 4
    # Power, the projection over the filterbank's non-zero weights, and the log.
    nonzero = int((fb != 0).sum().item())
    flops = batch * out_frames * (3 * n_bins + 2 * nonzero + n_mels)
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_F32_FLOPS)
    say("K1-spectrum", shape=f"spec{tuple(spec.shape)}->out{tuple(kernel_out.shape)}", max_abs_err=err,
        tolerance=K1_TOLERANCE, no_imaginary_fault=fault, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=bound_by, mbytes=f"{bytes_moved / 1e6:.1f}", gflop=f"{flops / 1e9:.3f}")
    if not err <= K1_TOLERANCE:
        raise AssertionError(f"K1 (spectrum form) disagrees with its plain version: {err} > {K1_TOLERANCE}")
    if not fault > K1_TOLERANCE:
        raise AssertionError(f"K1's limit would pass a power without its imaginary half: {fault}")
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


def _k1_fused_check(signal, fb, out_frames: int) -> dict:
    """K1's fused form on one (B, S) signal: normalized against the plain version, raw against
    float64 beside the plain route's own error, a planted one-TF32-pass fault, and the bits of two runs."""
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.ops import log_mel

    fused = log_mel.stft_power_mel_log(signal, fb, out_frames)
    again = log_mel.stft_power_mel_log(signal, fb, out_frames)
    plain = log_mel.stft_power_mel_log_reference(signal, fb, out_frames)
    exact = log_mel.power_mel_log_reference(log_mel.stft(signal.double(), 400, 160), fb.double(), out_frames)
    # Planted fault: the plain route with its frames and basis rounded to TF32 (one TF32 pass).
    padded = F.pad(signal[:, None, :], (200, 200), mode="reflect")[:, 0]
    frames = _tf32(padded.unfold(-1, 400, 160)[:, :out_frames])
    basis = _tf32(torch.from_numpy(log_mel._dft_basis(400)).cuda())
    one_pass = log_mel.power_mel_log_reference(frames @ basis, fb)
    del padded, frames
    torch.cuda.synchronize()
    norm = log_mel.normalize_log_mel
    return {
        "normalized_err": (norm(fused) - norm(plain)).abs().max().item(),
        "raw_err_vs_f64": (fused.double() - exact).abs().max().item(),
        "plain_raw_err_vs_f64": (plain.double() - exact).abs().max().item(),
        "one_tf32_pass_fault": (norm(one_pass) - norm(plain)).abs().max().item(),
        "same_bits": torch.equal(fused, again),
        "finite": bool(torch.isfinite(fused).all().item()),
    }


def phase_k1() -> dict:
    import torch

    from ser_tpu_torch.ops import filters, kernel_build, log_mel

    torch.manual_seed(0)
    batch, samples, n_mels, out_frames = 8, 30 * 16000, 128, 3000
    wave = 0.1 * torch.randn(batch, samples, device="cuda")
    log_mel.set_strict_float32()
    fb = torch.from_numpy(log_mel._mel_fb_t(16000, 400, n_mels)).cuda()
    spectrum = _k1_spectrum_form(wave, fb, out_frames)

    # The fused form (the main path's), on noise and on a 440 Hz tone with noise 1e-4 below it.
    t = torch.arange(samples, device="cuda", dtype=torch.float64) / 16000
    tone = (torch.sin(2 * math.pi * 440.0 * t) + 1e-4 * torch.randn(batch, samples, device="cuda",
                                                                     dtype=torch.float64)).float()
    checks = {name: _k1_fused_check(signal, fb, out_frames) for name, signal in (("noise", wave), ("tone", tone))}
    for name, check in checks.items():
        say("K1-check", signal=name, tolerance=K1_TOLERANCE, **check)
        if not check["normalized_err"] <= K1_TOLERANCE:
            raise AssertionError(f"K1 disagrees with its plain version on {name}: {check['normalized_err']}")
        if not check["raw_err_vs_f64"] <= 2.0 * check["plain_raw_err_vs_f64"]:
            raise AssertionError(f"K1's raw error against float64 on {name} exceeds twice the plain route's: {check}")
        if not check["one_tf32_pass_fault"] > K1_TOLERANCE:
            raise AssertionError(f"K1's limit would pass one TF32 pass on {name}: {check['one_tf32_pass_fault']}")
        if not (check["same_bits"] and check["finite"]):
            raise AssertionError(f"K1 gave other bits on a second run, or non-finite values, on {name}")

    # Shapes the main path does not give it: a window length that is neither a multiple of 4 nor
    # of 160 (plain loads fill the span) at 80 mels, and a waveform 4 bytes off 16-byte alignment.
    fb80 = torch.from_numpy(log_mel._mel_fb_t(16000, 400, 80)).cuda()
    shifted = 0.1 * torch.randn(16001, device="cuda")
    for name, signal, bank in (("odd_length_80_mels", 0.1 * torch.randn(3, 16077, device="cuda"), fb80),
                               ("misaligned", shifted[1:].view(1, 16000), fb)):
        check = _k1_fused_check(signal, bank, None)
        say("K1-check", signal=name, shape=json.dumps(list(signal.shape)), n_mels=bank.shape[1],
            tolerance=K1_TOLERANCE, **check)
        if not (check["normalized_err"] <= K1_TOLERANCE
                and check["raw_err_vs_f64"] <= 2.0 * check["plain_raw_err_vs_f64"]
                and check["same_bits"] and check["finite"]):
            raise AssertionError(f"K1 disagrees with its plain version on {name}: {check}")

    window = torch.from_numpy(filters.hann_window(400)).cuda()

    def torch_stft_route():
        x = torch.stft(wave, 400, 160, window=window, center=True, pad_mode="reflect", return_complex=True)
        return log_mel.power_mel_log(torch.cat([x.real, x.imag], dim=1).transpose(1, 2).contiguous(), fb, out_frames)

    stft_err = (log_mel.normalize_log_mel(torch_stft_route())
                - log_mel.normalize_log_mel(log_mel.stft_power_mel_log_reference(wave, fb, out_frames))).abs().max()
    # Every route timed the same way (cuda_ms), the routes taking turns, five readings each.
    times = interleaved_ms({
        "fused": lambda: log_mel.stft_power_mel_log(wave, fb, out_frames),
        "old_route": lambda: log_mel.power_mel_log(log_mel.stft(wave, 400, 160).contiguous(), fb, out_frames),
        "torch_stft_k1": torch_stft_route,
        "plain": lambda: log_mel.stft_power_mel_log_reference(wave, fb, out_frames),
    })
    ms = times["fused"]["ms"]
    n_bins = fb.shape[0]
    basis_bytes = log_mel.packed_fused_basis().nbytes
    bytes_moved = wave.numel() * 4 + basis_bytes + fb.numel() * 4 + batch * out_frames * n_mels * 4
    # The DFT the function needs (402 columns, 400 taps) as three TF32 products a product; the
    # kernel issues its padded 448 columns and 416 taps, a waste that counts in its time only.
    columns, taps = log_mel._N_TILE * log_mel._N_TILES, log_mel._K_CHUNK * log_mel._K_CHUNKS
    useful = 3 * 2.0 * batch * out_frames * (2 * n_bins) * 400
    issued = 3 * 2.0 * batch * out_frames * columns * taps
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=useful, peak_flops=PEAK_TF32_FLOPS)
    for line in kernel_build.ptxas_report("log_mel").splitlines():
        say("K1-ptxas", info=json.dumps(line.strip()))
    say("K1", shape=f"wave{tuple(wave.shape)}->out({batch}, {out_frames}, {n_mels})",
        card=json.dumps(nvidia_smi_line()), ms=spread(times["fused"]), old_route_ms=spread(times["old_route"]),
        torch_stft_k1_ms=spread(times["torch_stft_k1"]), torch_stft_normalized_err=stft_err.item(),
        plain_ms=spread(times["plain"]), bound_ms=f"{bound:.4f}", bound_by=bound_by,
        bound_share=f"{bound / ms:.3f}", tflops=f"{useful / ms / 1e9:.1f}", issued_tflops=f"{issued / ms / 1e9:.1f}",
        mbytes=f"{bytes_moved / 1e6:.1f}", gflop=f"{useful / 1e9:.2f}", issued_gflop=f"{issued / 1e9:.2f}")
    fused = {
        "name": "stft_power_mel_log",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/log_mel.cu",
        "replaces": "ser_tpu/ops/pallas_kernels.py:93",
        "also_replaces": "ser_tpu/ops/pallas_kernels.py:57 (conv_stft)",
        "max_abs_err": max(check["normalized_err"] for check in checks.values()),
        "tolerance": K1_TOLERANCE,
        "tolerance_on": "max_abs_err of the normalized log-mel, noise and tone",
        "raw_err_vs_f64": {name: check["raw_err_vs_f64"] for name, check in checks.items()},
        "plain_raw_err_vs_f64": {name: check["plain_raw_err_vs_f64"] for name, check in checks.items()},
        "ms": ms,
        "ms_range": [times["fused"]["min_ms"], times["fused"]["max_ms"]],
        "plain_ms": times["plain"]["ms"],
        "old_route_ms": times["old_route"]["ms"],
        "torch_stft_k1_ms": times["torch_stft_k1"]["ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }
    return {"fused": fused, "spectrum": spectrum}


# resample_rows (csrc/resample.cu), max abs error and relative L2 error against its plain version
# (float64 sums on the card, cast to float32) at audio levels (peak 0.8): the kernel sums in float32,
# about 1e-7 of a sample. The planted fault, rows one 16 kHz sample late (a wrong alignment), is off
# by the signal's change from one sample to the next, 1e-2 and more.
RESAMPLE_MAX_ABS = 1e-5
RESAMPLE_REL_L2 = 1e-6


def _resample_case(name: str, rate: int, clip_seconds: list[float], row_samples: int, n_rows: int) -> dict:
    """One shape of resample_rows: clips of ``clip_seconds`` at ``rate`` cut into rows of ``row_samples``
    (up to ``n_rows``, padding rows after them): the kernel against its plain version, a planted late
    start, the kernel's time (five readings) and the plain version's, the kernel's byte bound and
    share, and the host's resample_poly over the same clips."""
    import numpy as np
    import torch
    from scipy.signal import resample_poly

    from ser_tpu_torch.ops import resample

    up, down = resample.ratio(rate, 16000)
    rng = np.random.default_rng(rate)
    clips = []
    for seconds in clip_seconds:
        t = np.arange(int(seconds * rate)) / rate
        audio = 0.3 * rng.standard_normal(t.size) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
        clips.append((0.8 * audio / np.abs(audio).max()).astype(np.float32))
    offsets = np.concatenate([[0], np.cumsum([c.size for c in clips])[:-1]])
    placements = []
    for offset, clip in zip(offsets, clips):
        n16 = resample.resampled_length(clip.size, up, down)
        for start in range(0, n16, row_samples):
            placements.append((int(offset), clip.size, start, min(row_samples, n16 - start)))
    placements = placements[:n_rows]
    rows_np = resample.row_descriptors(placements, row_samples, up, down, n_rows=n_rows)
    source = torch.from_numpy(np.concatenate(clips)).cuda()
    rows = torch.from_numpy(rows_np).cuda()

    made = resample.resample_rows(source, rows, up, down, row_samples)
    plain = resample.resample_rows_reference(source, rows, up, down, row_samples)
    late = rows.clone()
    late[:, 2] += (late[:, 3] > 0).long()
    late[:, 3] = torch.minimum(late[:, 3], late[:, 1] * up // down - late[:, 2]).clamp(min=0)
    planted = resample.resample_rows_reference(source, late, up, down, row_samples)
    torch.cuda.synchronize()
    err = (made - plain).abs().max().item()
    rel = ((made.double() - plain.double()).norm() / plain.double().norm()).item()
    planted_err = (planted - plain).abs().max().item()
    padding_zero = all(not made[b, int(v):].any() for b, v in enumerate(rows_np[:, 3]))
    again = resample.resample_rows(source, rows, up, down, row_samples)
    same_bits = bool(torch.equal(made, again))
    if not (err <= RESAMPLE_MAX_ABS and rel <= RESAMPLE_REL_L2 and padding_zero and same_bits):
        raise AssertionError(f"resample_rows disagrees with its plain version at {name}: max abs {err}, "
                             f"rel {rel}, padding zero {padding_zero}, same bits {same_bits}")
    if not planted_err > RESAMPLE_MAX_ABS:
        raise AssertionError(f"resample_rows' limit would pass rows one sample late at {name}: {planted_err}")

    # The kernel read five times (median, lowest, highest); the plain version, whose host waits on
    # the card (its row count), by span_ms.
    readings = [cuda_ms(lambda: resample.resample_rows(source, rows, up, down, row_samples)) for _ in range(5)]
    kernel = {"ms": statistics.median(readings), "min_ms": min(readings), "max_ms": max(readings)}
    plain_ms = span_ms(lambda: resample.resample_rows_reference(source, rows, up, down, row_samples))
    # The bytes the work needs: each clip's samples that the rows reach read once, the rows written once.
    used = sum({offset: length for offset, length, _, _ in placements}.values())
    bytes_moved = 4 * used + 4 * n_rows * row_samples + rows_np.nbytes + resample.kernel_table(up, down).nbytes
    kt = resample.polyphase_table(up, down).shape[1]
    flops = 2.0 * kt * int(rows_np[:, 3].sum())
    bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_F32_FLOPS)
    library_ms = library_err = None
    if up == 1:
        library = _conv1d_rows(source, placements, down, row_samples, n_rows)
        library_err = (library - plain).abs().max().item()
        if not library_err <= RESAMPLE_MAX_ABS:
            raise AssertionError(f"the conv1d route disagrees with the plain version at {name}: {library_err}")
        # Up to 11 convolutions and 22 copies a call: the host's launches may outlast cuda_ms's hold.
        library_ms = span_ms(lambda: _conv1d_rows(source, placements, down, row_samples, n_rows), iters=10)
    started = time.perf_counter()
    for clip in clips:
        resample_poly(clip.astype(np.float64), up, down)
    host_ms = (time.perf_counter() - started) * 1e3
    ms = kernel["ms"]
    say("resample", case=name, ratio=f"{up}/{down}", rows=f"{n_rows}x{row_samples}", taps_per_output=kt,
        card=json.dumps(nvidia_smi_line()), ms=spread(kernel), plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=bound_by, bound_share=f"{bound / ms:.3f}",
        gbytes_per_s=f"{bytes_moved / ms / 1e6:.0f}", mbytes=f"{bytes_moved / 1e6:.1f}",
        host_resample_poly_ms=f"{host_ms:.1f}", max_abs_err=err, rel_l2_err=rel, planted_late_err=planted_err,
        library_ms=None if library_ms is None else f"{library_ms:.4f}", library_max_abs_err=library_err)
    return {"case": name, "ms": ms, "ms_range": [kernel["min_ms"], kernel["max_ms"]],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "rel_l2_err": rel, "host_resample_poly_ms": host_ms, "library_ms": library_ms}


def _conv1d_rows(source, placements, down: int, row_samples: int, n_rows: int):
    """The rows of ``resample_rows`` at a ratio of 1/down by torch's own ops (TF32 off): each clip
    the placements reach zero-extended by the filter's half length and filtered by ``conv1d`` at
    stride ``down``, then each row's stretch copied into zeroed rows."""
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.ops import resample

    half = resample.half_length(1, down)
    weight = torch.from_numpy(resample.filter_taps(1, down)[::-1].astype("float32")).to(source.device).view(1, 1, -1)
    out = torch.zeros((n_rows, row_samples), dtype=torch.float32, device=source.device)
    filtered = {}
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for row, (offset, length, start, valid) in enumerate(placements):
            if offset not in filtered:
                clip = F.pad(source[offset: offset + length].view(1, 1, -1), (half, half + down))
                filtered[offset] = F.conv1d(clip, weight, stride=down).view(-1)
            out[row, :valid] = filtered[offset][start: start + valid]
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return out


def _resample_card_checks() -> dict:
    """The kernel's launch counter, the wrapper's refusals on the card, and a traced ``infer_many`` of two
    48 kHz clips (2.3 s and 31 s, the second two windows) whose rows are made on the card."""
    import torch
    from torch.profiler import ProfilerActivity

    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.utils import profiling
    from ser_tpu_torch.ops import resample
    from ser_tpu_torch.parallel.batch_inference import infer_many

    card = torch.device("cuda")
    source = torch.zeros(48000, device=card)
    rows = torch.tensor([[0, 48000, 0, 16000], [0, 0, 0, 0]], dtype=torch.int64, device=card)
    before = resample.COUNTER.launches
    resample.resample_rows(source, rows, 1, 3, 16000)
    resample.resample_rows(source, rows, 1, 3, 16000)
    if resample.COUNTER.launches != before + 2:
        raise AssertionError(f"two launches advanced the counter by {resample.COUNTER.launches - before}")
    refusals = {
        "rows on the host": (ValueError, lambda: resample.resample_rows(source, rows.cpu(), 1, 3, 16000)),
        "source on the host": (ValueError, lambda: resample.resample_rows(source.cpu(), rows, 1, 3, 16000)),
        "half source": (TypeError, lambda: resample.resample_rows(source.half(), rows, 1, 3, 16000)),
        "int32 rows": (TypeError, lambda: resample.resample_rows(source, rows.int(), 1, 3, 16000)),
        "strided source": (ValueError,
                           lambda: resample.resample_rows(torch.zeros(96000, device=card)[::2], rows, 1, 3, 16000)),
    }
    for what, (error, call) in refusals.items():
        try:
            call()
        except error:
            continue
        raise AssertionError(f"resample_rows took {what}")

    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_resample_") as tmp:
        root = Path(tmp)
        _write_head_envelope(root / "models" / profile_artifact_file_name(profile="accurate",
                                                                          model_id="openai/whisper-large-v3"),
                             feature_size=2 * 1280)
        settings = build_settings({"SER_ENABLE_ACCURATE_PROFILE": "1", "SER_MODELS_FOLDER": str(root / "models"),
                                   "SER_CACHE_DIR": str(root / "cache")})
        paths, made = [], 0
        for index, seconds in enumerate((2.3, 31.0)):
            paths.append(str(root / f"clip{index}.wav"))
            _write_clip(Path(paths[-1]), seconds, 48000, seed=30 + index)
            made += resample.resampled_length(int(seconds * 48000), 1, 3)
        try:
            infer_many(paths, profile="accurate", settings=settings)  # warm: the build and the encoder
            profiling.reset_counts()
            launches = resample.COUNTER.launches
            with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as traced:
                results = infer_many(paths, profile="accurate", settings=settings)
            counts = profiling.counts()
        finally:
            profiling.reset_counts()
            encoders._BACKEND_CACHE.clear()
    stages = [e.name for e in sorted(traced.events(), key=lambda e: e.time_range.start)
              if e.name in ("ser.resample", "ser.encode", "ser.fetch")]
    reading = {"launches": resample.COUNTER.launches - launches, "card_samples": counts["resample_card_samples"],
               "host_samples": counts["resample_host_samples"], "expected_card_samples": made,
               "stages": stages}
    say("resample-infer-many", refusals=json.dumps(sorted(refusals)), **{k: json.dumps(v) for k, v in reading.items()})
    if any(row.error is not None for row in results):
        raise AssertionError(f"infer_many failed: {[row.error for row in results]}")
    if (reading["launches"], reading["card_samples"], reading["host_samples"]) != (2, made, 0) \
            or stages != ["ser.resample", "ser.encode", "ser.fetch"] * 2:
        raise AssertionError(f"the traced infer_many did not make its rows on the card: {reading}")
    return reading


def phase_resample() -> dict:
    """resample_rows at the main path's shapes: one 600 s file at 48 kHz into Whisper's 20 windows
    (large-v3.long-files' longest), xlsr-300m.mixed-files' largest bucket batch (22 rows of the 30 s
    bucket: two rows of each of ten 60 s clips, the second starting inside its clip, a 20 s clip's
    row and a padding row), and the 600 s file at 44.1 kHz; then at 1/1 (a 40 s 16 kHz clip) and at
    16000/7919 (a tile's span too long for shared memory), and :func:`_resample_card_checks`."""
    from ser_tpu_torch.ops import kernel_build

    for line in kernel_build.ptxas_report("resample").splitlines():
        say("resample-ptxas", info=json.dumps(line.strip()))
    cases = [
        _resample_case("long-file-48k", 48000, [600.0], 480000, 20),
        _resample_case("bucket-batch-48k", 48000, [60.0] * 10 + [20.0], 480000, 22),
        _resample_case("long-file-44k1", 44100, [600.0], 480000, 20),
        _resample_case("copy-16k", 16000, [40.0], 480000, 3),
        _resample_case("device-memory-7919", 7919, [3.0], 480000, 2),
    ]
    checks = _resample_card_checks()
    first = cases[0]
    return {
        "name": "resample_rows",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/resample.cu",
        "replaces": "none (port-only: the JAX package resamples on the host, "
                    "ser_tpu/_internal/utils/audio_io.py::resample_audio)",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": RESAMPLE_MAX_ABS,
        "tolerance_on": "max abs error of the rows against the plain version (float64 sums)",
        "ms": first["ms"],
        "ms_range": first["ms_range"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "library": "torch conv1d at stride 3 per clip, the rows copied out (TF32 off)",
        "cases": cases,
        "card_checks": checks,
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


def _ragged_mask(batch: int, seq: int, step: int):
    """A (B, T) key mask whose rows keep T, T - step, T - 2 step, ... keys."""
    import torch

    lengths = torch.tensor([seq - step * i for i in range(batch)], device="cuda")
    return torch.arange(seq, device="cuda")[None, :] < lengths[:, None]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), kept in float32."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


def _tf32_attention(q, k, v, frame_mask):
    """The plain version with every product's operands rounded to TF32 (a planted fault)."""
    import torch

    scores = torch.einsum("bqhd,bkhd->bhqk", _tf32(q), _tf32(k)) / math.sqrt(q.shape[-1])
    if frame_mask is not None:
        scores = scores + torch.where(frame_mask[:, None, None, :], 0.0, -1e30)
    weights = torch.softmax(scores, dim=-1)
    del scores
    return torch.einsum("bhqk,bkhd->bqhd", _tf32(weights), _tf32(v))


def _split_attention(q, k, v, frame_mask, *, drop_cross: bool):
    """The plain version with each product as K2-f32 splits it: x = hi + lo (TF32 each),
    x y = lo_x hi_y + hi_x lo_y + hi_x hi_y. ``drop_cross`` leaves out lo_x hi_y (a planted
    fault: one cross term dropped)."""
    import torch

    def product(equation, x, y):
        x_hi, y_hi = _tf32(x), _tf32(y)
        x_lo, y_lo = _tf32(x - x_hi), _tf32(y - y_hi)
        total = torch.einsum(equation, x_hi, y_lo) + torch.einsum(equation, x_hi, y_hi)
        if not drop_cross:
            total = torch.einsum(equation, x_lo, y_hi) + total
        return total

    scores = product("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if frame_mask is not None:
        scores = scores + torch.where(frame_mask[:, None, None, :], 0.0, -1e30)
    weights = torch.softmax(scores, dim=-1)
    del scores
    return product("bhqk,bkhd->bqhd", weights, v)


def _sdpa_ms(q, k, v, frame_mask) -> float:
    """SDPA's time on the same tensors (the library call; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if frame_mask is None else frame_mask[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask))


def phase_k2_f32() -> dict:
    """K2-f32 against the float32 plain version: medium shapes masked, Whisper's unmasked, T = 1409, and the
    training encode's 4 s bucket (batch 32 and 1) masked."""
    import torch

    from ser_tpu_torch.models import attention

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 is on for float32 matmuls: the plain version would not be float32")
    torch.manual_seed(3)
    cases = (("medium", MEDIUM_ATTENTION, _ragged_mask(*MEDIUM_ATTENTION[:2], 150)),
             ("whisper", (8, 1500, 20, 64), None), ("ragged", (8, RAGGED_SEQ, 16, 64), None),
             *_training_attention_cases(16, 64))
    lines = {}
    for label, (batch, seq, heads, dim), mask in cases:
        q, k, v = (torch.randn(batch, seq, heads, dim, device="cuda") for _ in range(3))
        out = attention.flash_attention(q, k, v, frame_mask=mask)
        ref = attention.attention_reference(q, k, v, frame_mask=mask)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        line = {"max_abs_err": err, "rel_l2_err": rel_l2(out, ref)}
        if not err <= K2_F32_TOLERANCE:
            raise AssertionError(f"K2-f32 ({label}) disagrees with its plain version: {err} > {K2_F32_TOLERANCE}")
        del out
        if label == "ragged":
            lines[label] = line
            continue
        if label.startswith("4s"):
            # The training shapes: the planted leak of the padded frames into the keys, and the times.
            line["mask_leak_fault"] = (attention.attention_reference(q, k, v) - ref)[mask].abs().max().item()
            if not line["mask_leak_fault"] > K2_F32_TOLERANCE:
                raise AssertionError(f"K2-f32's limit would pass a leak of the masked keys ({label}): {line}")
            line.update(ms=cuda_ms(lambda: attention.flash_attention(q, k, v, frame_mask=mask)),
                        library_ms=_sdpa_ms(q, k, v, mask))
            lines[label] = line
            del q, k, v, ref
            continue
        # Planted faults the limit must catch: TF32 operands; the split with one cross
        # term dropped; the masked keys let into the softmax.
        line["tf32_fault"] = (_tf32_attention(q, k, v, mask) - ref).abs().max().item()
        line["dropped_term_fault"] = (_split_attention(q, k, v, mask, drop_cross=True) - ref).abs().max().item()
        line["split_emulation_err"] = (_split_attention(q, k, v, mask, drop_cross=False) - ref).abs().max().item()
        faults = [line["tf32_fault"], line["dropped_term_fault"]]
        if mask is not None:
            leaky = attention.attention_reference(q, k, v)
            line["mask_leak_fault"] = (leaky - ref)[mask].abs().max().item()
            faults.append(line["mask_leak_fault"])
            del leaky
        del ref
        if not min(faults) > K2_F32_TOLERANCE:
            raise AssertionError(f"K2-f32's limit would pass a planted fault ({label}): {faults}")
        torch.cuda.empty_cache()
        flops = 4.0 * batch * heads * seq * seq * dim
        bytes_moved = 4 * q.numel() * 4 + (0 if mask is None else mask.numel())
        # Float32-grade products on the tensor cores: three TF32 products each.
        bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=3.0 * flops, peak_flops=PEAK_TF32_FLOPS)
        line.update(
            ms=cuda_ms(lambda: attention.flash_attention(q, k, v, frame_mask=mask)),
            plain_ms=span_ms(lambda: attention.attention_reference(q, k, v, frame_mask=mask)),
            library_ms=_sdpa_ms(q, k, v, mask),
            bound_ms=bound,
            bound_by=bound_by,
            fp32_fma_bound_ms=flops / PEAK_F32_FLOPS * 1e3,
            gflop=flops / 1e9,
        )
        line.update(tflops=flops / line["ms"] / 1e9, bound_share=bound / line["ms"],
                    ms_over_library=line["ms"] / line["library_ms"])
        lines[label] = line
        del q, k, v
        torch.cuda.empty_cache()
    for label, line in lines.items():
        say("K2-f32", case=label, tolerance=K2_F32_TOLERANCE,
            **{key: (f"{value:.6g}" if isinstance(value, float) else value) for key, value in line.items()})
    medium = lines["medium"]
    return {
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/flash_attention_f32.cu",
        "replaces": "ser_tpu/models/attention.py:117",
        "shape": f"(B,T,H,D)={MEDIUM_ATTENTION} float32, key mask",
        "max_abs_err": max(line["max_abs_err"] for line in lines.values()),
        "rel_l2_err": medium["rel_l2_err"],
        "tolerance": K2_F32_TOLERANCE,
        "tolerance_on": "max_abs_err",
        "ms": medium["ms"],
        "plain_ms": medium["plain_ms"],
        "bound_ms": medium["bound_ms"],
        "bound_by": medium["bound_by"],
        "bound_assumes": "3 TF32 products per product at 494.7 TFLOP/s",
        "fp32_fma_bound_ms": medium["fp32_fma_bound_ms"],
        "library_ms": medium["library_ms"],
        "whisper_shape_ms": lines["whisper"]["ms"],
        "whisper_shape_library_ms": lines["whisper"]["library_ms"],
        "train_shapes": {label: lines[label]["max_abs_err"] for label in ("4s-train", "4s-smoke")},
    }


def _clip_mask(batch: int, seq: int, valid: int):
    """A (B, T) key mask whose rows keep their first ``valid`` keys (equal clips in one bucket)."""
    import torch

    return (torch.arange(seq, device="cuda")[None, :] < valid).expand(batch, seq).contiguous()


def _training_attention_cases(heads: int, dim: int) -> tuple:
    """The medium and research training encodes' attention: a batch of 32 clips of 3 s in the 4 s bucket, and
    a smoke probe's one clip; (label, shape, mask)."""
    return tuple((label, (batch, TRAIN_BUCKET_FRAMES, heads, dim),
                  _clip_mask(batch, TRAIN_BUCKET_FRAMES, TRAIN_CLIP_FRAMES))
                 for label, batch in (("4s-train", TRAIN_ENCODE_BATCH), ("4s-smoke", 1)))


def phase_k2_medium() -> dict:
    """Masked bf16 K2 at the medium profile's shapes (30 s and 15 s buckets, and the training encode's 4 s
    bucket at batch 32 and 1) against its plain version."""
    import torch

    from ser_tpu_torch.models import attention

    torch.manual_seed(4)
    batch, seq, heads, dim = MEDIUM_ATTENTION
    cases = (("30s", (batch, seq, heads, dim), _ragged_mask(batch, seq, seq // 10)),
             ("15s", (batch, MEDIUM_HALF_BUCKET_FRAMES, heads, dim),
              _ragged_mask(batch, MEDIUM_HALF_BUCKET_FRAMES, MEDIUM_HALF_BUCKET_FRAMES // 10)),
             *_training_attention_cases(heads, dim))
    result = {}
    for label, (batch, frames, heads, dim), mask in cases:
        q, k, v = (torch.randn(batch, frames, heads, dim, device="cuda").to(torch.bfloat16) for _ in range(3))
        out = attention.flash_attention(q, k, v, frame_mask=mask)
        qf, kf, vf = (t.float() for t in (q, k, v))
        ref = attention.attention_reference(qf, kf, vf, frame_mask=mask)
        err = rel_l2(out, ref)
        leak = rel_l2(attention.attention_reference(qf, kf, vf)[mask], ref[mask])
        del out, ref, qf, kf, vf
        if not err <= K2_REL_L2_TOLERANCE:
            raise AssertionError(f"masked K2 ({label}) disagrees with its plain version: {err} > {K2_REL_L2_TOLERANCE}")
        if not leak > K2_REL_L2_TOLERANCE:
            raise AssertionError(f"K2's limit would pass a leak of the masked keys ({label}): {leak}")
        masked_ms = cuda_ms(lambda: attention.flash_attention(q, k, v, frame_mask=mask))
        unmasked_ms = cuda_ms(lambda: attention.flash_attention(q, k, v))
        flops = 4.0 * batch * heads * frames * frames * dim
        bound, bound_by = bound_ms(bytes_moved=4 * q.numel() * 2, flops=flops, peak_flops=PEAK_BF16_FLOPS)
        library_ms = _sdpa_ms(q, k, v, mask)
        say("K2-medium", bucket=label, shape=f"(B,T,H,D)=({batch},{frames},{heads},{dim}) bf16", rel_l2_err=err,
            rel_l2_tolerance=K2_REL_L2_TOLERANCE, mask_leak_fault=f"{leak:.5f}", masked_ms=f"{masked_ms:.4f}",
            unmasked_ms=f"{unmasked_ms:.4f}", masked_over_unmasked=f"{masked_ms / unmasked_ms:.3f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
            **_rates(flops, masked_ms, bound, library_ms))
        result[label] = {"rel_l2_err": err, "masked_ms": masked_ms, "unmasked_ms": unmasked_ms,
                         "library_ms": library_ms, "bound_ms": bound}
        del q, k, v
    return result


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
    """A kernel without an autograd Function refuses an input that requires grad (K1's two forms, K3)."""
    import torch

    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    spec = torch.zeros(1, 8, 402, device="cuda", requires_grad=True)
    wave = torch.zeros(1, 16000, device="cuda", requires_grad=True)
    fb = torch.zeros(201, 128, device="cuda")
    d = 1280
    x = torch.zeros(2, d, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    ln, w, b = (torch.zeros(shape, device="cuda", dtype=torch.bfloat16) for shape in ((1, d), (d, 3 * d), (1, 3 * d)))
    refused = {}
    for name, call in (("K1", lambda: log_mel.power_mel_log(spec, fb)),
                       ("K1-fused", lambda: log_mel.stft_power_mel_log(wave, fb)),
                       ("K3", lambda: dsk.ln_qkv_project(x, ln, ln, w, b, eps=1e-5))):
        try:
            call()
        except RuntimeError as err:
            refused[name] = "no backward" in str(err)
        else:
            refused[name] = False
    with torch.no_grad():  # the same calls without grad mode launch
        log_mel.power_mel_log(spec, fb)
        log_mel.stft_power_mel_log(wave, fb)
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

    d, n_out, eps = 1280, 3840, 1e-5
    heads, s_max = d // 64, 448
    cache_positions = (0, 100, s_max - 1)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def operands(rows):
        # A residual stream with an offset (so the LayerNorm's mean matters).
        return (
            _bf16(gen, rows, d, shift=0.5),
            _bf16(gen, 1, d, scale=0.1, shift=1.0),
            _bf16(gen, 1, d, scale=0.1),
            _bf16(gen, d, n_out, scale=d**-0.5),
            _bf16(gen, 1, n_out, scale=0.1),
        )

    def caches(rows):
        return _bf16(gen, rows, heads, 64, s_max), _bf16(gen, rows, heads, s_max, 64)

    def check(rows) -> dict:
        args = operands(rows)
        out = dsk.ln_qkv_project(*args, eps=eps)
        ref = dsk.ln_qkv_project_reference(*(t.float() for t in args), eps=eps)
        torch.cuda.synchronize()
        err, rel = (out.float() - ref).abs().max().item(), rel_l2(out, ref)
        same_bits = torch.equal(out, dsk.ln_qkv_project(*args, eps=eps))
        # Planted fault: a LayerNorm that does not subtract the mean.
        x, scale, bias, w, b = (t.float() for t in args)
        no_mean = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale + bias
        fault = rel_l2(no_mean @ w + b, ref)
        if not rel <= K3_REL_L2_TOLERANCE:
            raise AssertionError(f"K3 at {rows} rows disagrees with its plain version: rel L2 {rel} > "
                                 f"{K3_REL_L2_TOLERANCE}")
        if not fault > K3_REL_L2_TOLERANCE:
            raise AssertionError(f"K3's limit at {rows} rows would pass a LayerNorm without its mean: {fault}")
        if not same_bits:
            raise AssertionError(f"K3 at {rows} rows gave other bits on a second run")
        # The cache form: q, and the K and V columns at `position` written in place, exactly
        # the plain version's cache writes of the same output; no other slot moves.
        for position in cache_positions:
            k_cache, v_cache = caches(rows)
            k_plain, v_plain = k_cache.clone(), v_cache.clone()
            q = dsk.ln_qkv_project_to_cache(*args, k_cache, v_cache, position, eps=eps)
            q_plain = dsk.write_cache_columns(out, k_plain, v_plain, position)
            torch.cuda.synchronize()
            if not (torch.equal(q, q_plain) and torch.equal(k_cache, k_plain) and torch.equal(v_cache, v_plain)):
                raise AssertionError(f"K3's cache form at {rows} rows differs from the plain cache writes at "
                                     f"position {position}")
        bytes_moved = 2 * (rows * d + 2 * d + d * n_out + n_out + rows * n_out)
        sets = [args] + [operands(rows) for _ in range(copies_for(bytes_moved) - 1)]
        bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=2.0 * rows * d * n_out,
                                   peak_flops=PEAK_BF16_FLOPS)
        return {"sets": sets, "bytes_moved": bytes_moved, "max_abs_err": err, "rel_l2_err": rel, "fault": fault,
                "same_bits": same_bits, "bound_ms": bound, "bound_by": bound_by,
                "ms": rotating_ms(lambda *a: dsk.ln_qkv_project(*a, eps=eps), sets),
                "plain_ms": rotating_ms(lambda *a: dsk.ln_qkv_project_reference(*a, eps=eps), sets)}

    # Two rows (two windows decoded in lockstep) and one (a clip of 30 s or less: the default request).
    checks = {rows: check(rows) for rows in (2, 1)}
    two = checks[2]
    rows, sets = 2, two["sets"]
    cache_sets = [a + caches(rows) for a in sets]
    cache_ms = rotating_ms(lambda *a: dsk.ln_qkv_project_to_cache(*a, s_max - 1, eps=eps), cache_sets)
    unfused_ms = rotating_ms(
        lambda x, s, bi, w, b: wd._dense_kernel({"kernel": w, "bias": b}, wd._layer_norm(_Affine(s, bi), x, eps),
                                                torch.bfloat16),
        sets,
    )
    plain_cache_ms = rotating_ms(
        lambda *a: dsk.ln_qkv_project_to_cache_reference(*a, s_max - 1, eps=eps), cache_sets
    )
    for label, count in (("K3", 2), ("K3-one-row", 1)):
        reading = checks[count]
        say(label, shape=f"x({count},{d}) W({d},{n_out}) bf16",
            max_abs_err=reading["max_abs_err"], rel_l2_err=reading["rel_l2_err"],
            rel_l2_tolerance=K3_REL_L2_TOLERANCE, no_mean_fault_rel_l2=reading["fault"],
            same_bits=reading["same_bits"], cache_form_exact_at=json.dumps(list(cache_positions)),
            ms=f"{reading['ms']:.4f}", plain_ms=f"{reading['plain_ms']:.4f}", bound_ms=f"{reading['bound_ms']:.4f}",
            bound_by=reading["bound_by"], bound_share=f"{reading['bound_ms'] / reading['ms']:.3f}",
            gb_per_s=f"{reading['bytes_moved'] / reading['ms'] / 1e6:.1f}")
    say("K3-routes", rows=rows, cache_form_ms=f"{cache_ms:.4f}", plain_cache_form_ms=f"{plain_cache_ms:.4f}",
        unfused_ms=f"{unfused_ms:.4f}")
    return {
        "name": "ln_qkv_project",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:94",
        "max_abs_err": max(reading["max_abs_err"] for reading in checks.values()),
        "rel_l2_err": max(reading["rel_l2_err"] for reading in checks.values()),
        "tolerance": K3_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": two["ms"],
        "cache_form_ms": cache_ms,
        "plain_ms": two["plain_ms"],
        "unfused_ms": unfused_ms,
        "bound_ms": two["bound_ms"],
        "bound_by": two["bound_by"],
        "library_ms": None,
        "one_row": _one_row(checks[1]),
    }


def _one_row(reading: dict) -> dict:
    """A decode-step kernel's reading at one row (the default request's decode), beside its two-row keys."""
    return {key: reading[key] for key in ("max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by")}


def phase_k4() -> dict:
    import torch

    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    heads, head_dim, s_max, d = 20, 64, 448, 1280
    position = s_max - 1  # the timed position
    gen = torch.Generator(device="cuda").manual_seed(4)

    def operands(rows):
        return (
            _bf16(gen, rows, heads, head_dim),
            _bf16(gen, rows, heads, head_dim, s_max),
            _bf16(gen, rows, heads, s_max, head_dim),
            _bf16(gen, heads, head_dim, d, scale=d**-0.5),
            _bf16(gen, 1, d, scale=0.1),
            _bf16(gen, rows, d, scale=0.1),
        )

    def check(rows) -> dict:
        args = operands(rows)
        q, k, v, w_out, b_out, x = args
        cluster = dsk._cluster_size(False, rows, heads, s_max, d, torch.cuda.current_device())
        # A position that ends a chunk, and the next one, which starts the next chunk.
        edge = next(p for p in range(8, s_max - 1)
                    if (p + 1) % dsk.chunk_keys(p + 1, cluster) == 0
                    and dsk.chunk_keys(p + 2, cluster) == dsk.chunk_keys(p + 1, cluster))
        if not any(start == edge + 1 for start, _ in dsk.chunk_bounds(edge + 2, cluster)):
            raise AssertionError(f"K4: position {edge + 1} does not start a chunk over {cluster} CTAs")
        readings = {}
        same_bits = True
        for at in (0, edge, edge + 1, 100, s_max - 1):
            # Poison the future slots: a kernel that reads them cannot agree.
            k_p, v_p = k.clone(), v.clone()
            k_p[..., at + 1 :] = 1e4
            v_p[:, :, at + 1 :, :] = -1e4
            out = dsk.self_attend_and_out(q, k_p, v_p, w_out, b_out, x, at)
            again = dsk.self_attend_and_out(q, k_p, v_p, w_out, b_out, x, at)
            ref = dsk.self_attend_and_out_reference(q.float(), k_p.float(), v_p.float(), w_out.float(),
                                                    b_out.float(), x.float(), at)
            torch.cuda.synchronize()
            same_bits = same_bits and torch.equal(out, again)
            rel = rel_l2(out, ref)
            if not rel <= K4_REL_L2_TOLERANCE:
                raise AssertionError(f"K4 at {rows} rows, position {at} disagrees with its plain version: "
                                     f"rel L2 {rel}")
            fault = None
            if at + 1 < s_max:
                # Planted fault: one key past position, into the poisoned slots.
                leaky = dsk.self_attend_and_out_reference(q.float(), k_p.float(), v_p.float(), w_out.float(),
                                                          b_out.float(), x.float(), at + 1)
                fault = rel_l2(leaky, ref)
                if not fault > K4_REL_L2_TOLERANCE:
                    raise AssertionError(f"K4's limit at {rows} rows would pass a read one key past position "
                                         f"{at}: {fault}")
            readings[at] = ((out.float() - ref).abs().max().item(), rel, fault)
        if not same_bits:
            raise AssertionError(f"K4 at {rows} rows gave other bits on a second run of the same inputs")
        keys = position + 1
        bytes_moved = 2 * (q.numel() + 2 * rows * heads * head_dim * keys + w_out.numel() + 2 * d + 2 * rows * d)
        flops = 4.0 * rows * heads * head_dim * keys + 2.0 * rows * heads * head_dim * d
        sets = [args] + [operands(rows) for _ in range(copies_for(bytes_moved) - 1)]
        bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
        return {"sets": sets, "bytes_moved": bytes_moved, "readings": readings, "same_bits": same_bits,
                "cluster": cluster, "edge": edge, "max_abs_err": max(e for e, _, _ in readings.values()),
                "rel_l2_err": max(r for _, r, _ in readings.values()), "bound_ms": bound, "bound_by": bound_by,
                "ms": rotating_ms(lambda *a: dsk.self_attend_and_out(*a, position), sets),
                "plain_ms": rotating_ms(lambda *a: dsk.self_attend_and_out_reference(*a, position), sets)}

    # Two rows (two windows decoded in lockstep) and one (a clip of 30 s or less: the default request).
    checks = {rows: check(rows) for rows in (2, 1)}
    two, rows = checks[2], 2
    bias_row = torch.where(torch.arange(s_max, device="cuda") <= position, 0.0, -1e30)

    def unfused(q, k, v, w_out, b_out, x):
        out = wd._attend_self_step(q[:, None], k, v, bias_row=bias_row, compute_dtype=torch.bfloat16)
        return x + wd._dense(_Affine(w_out.reshape(heads * head_dim, d).t(), b_out[0]), out.reshape(rows, -1),
                             torch.bfloat16)

    unfused_ms = rotating_ms(unfused, two["sets"])
    for label, count in (("K4", 2), ("K4-one-row", 1)):
        reading = checks[count]
        say(label, shape=f"q({count},{heads},{head_dim}) cache({count},{heads},{head_dim},{s_max}) bf16",
            cluster=reading["cluster"], chunk_edge=f"{reading['edge']}|{reading['edge'] + 1}",
            same_bits=reading["same_bits"],
            positions=json.dumps({str(p): [f"{e:.3g}", f"{r:.5f}", None if f is None else f"{f:.3g}"]
                                  for p, (e, r, f) in reading["readings"].items()}),
            rel_l2_tolerance=K4_REL_L2_TOLERANCE, timed_position=position, ms=f"{reading['ms']:.4f}",
            plain_ms=f"{reading['plain_ms']:.4f}", bound_ms=f"{reading['bound_ms']:.4f}",
            bound_by=reading["bound_by"], gb_per_s=f"{reading['bytes_moved'] / reading['ms'] / 1e6:.1f}")
    say("K4-routes", rows=rows, unfused_ms=f"{unfused_ms:.4f}")
    return {
        "name": "self_attend_and_out",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:175",
        "max_abs_err": max(reading["max_abs_err"] for reading in checks.values()),
        "rel_l2_err": max(reading["rel_l2_err"] for reading in checks.values()),
        "same_bits": all(reading["same_bits"] for reading in checks.values()),
        "cluster": two["cluster"],
        "tolerance": K4_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": two["ms"],
        "plain_ms": two["plain_ms"],
        "unfused_ms": unfused_ms,
        "bound_ms": two["bound_ms"],
        "bound_by": two["bound_by"],
        "library_ms": None,
        "one_row": {**_one_row(checks[1]), "cluster": checks[1]["cluster"]},
    }


def phase_k5() -> dict:
    import torch

    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk

    heads, head_dim, s_len, d, eps = 20, 64, 1500, 1280, 1e-5
    # A second S whose last CTA gets a short chunk (1000 over 8 CTAs: 7 x 128 and 104).
    short_s = 1000
    gen = torch.Generator(device="cuda").manual_seed(5)

    def operands(rows):
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

    def check(rows) -> dict:
        args = operands(rows)
        cluster = dsk._cluster_size(True, rows, heads, s_len, d, torch.cuda.current_device())
        out, weights = dsk.cross_attention_step(*args, eps=eps)
        again, weights_again = dsk.cross_attention_step(*args, eps=eps)
        ref, ref_weights = dsk.cross_attention_step_reference(*(t.float() for t in args), eps=eps)
        torch.cuda.synchronize()
        same_bits = torch.equal(out, again) and torch.equal(weights, weights_again)
        if not same_bits:
            raise AssertionError(f"K5 at {rows} rows gave other bits on a second run of the same inputs")
        err, rel = (out.float() - ref).abs().max().item(), rel_l2(out, ref)
        weights_rel = rel_l2(weights, ref_weights)
        sum_err = (weights.sum(-1) - 1.0).abs().max().item()
        short_cluster = dsk._cluster_size(True, rows, heads, short_s, d, torch.cuda.current_device())
        short_args = (*args[:5], args[5][..., :short_s].contiguous(), args[6][:, :, :short_s].contiguous(),
                      *args[7:])
        short_out, short_weights = dsk.cross_attention_step(*short_args, eps=eps)
        short_ref, short_ref_weights = dsk.cross_attention_step_reference(*(t.float() for t in short_args),
                                                                          eps=eps)
        torch.cuda.synchronize()
        short_rel = max(rel_l2(short_out, short_ref), rel_l2(short_weights, short_ref_weights))
        short_sum_err = (short_weights.sum(-1) - 1.0).abs().max().item()
        short_chunks = [stop - start for start, stop in dsk.chunk_bounds(short_s, short_cluster)]
        if not short_rel <= K5_REL_L2_TOLERANCE or not short_sum_err <= K5_WEIGHT_SUM_TOLERANCE:
            raise AssertionError(f"K5 at {rows} rows, S = {short_s} disagrees: rel L2 {short_rel}, weight sum "
                                 f"{short_sum_err}")
        # Planted fault: a softmax that leaves out the last partial 64-key tile (1500 = 23 * 64 + 28).
        kept = s_len // 64 * 64
        x, scale, bias, w_q, b_q, k, v, w_out, b_out = (t.float() for t in args)
        short, _ = dsk.cross_attention_step_reference(x, scale, bias, w_q, b_q, k[..., :kept].contiguous(),
                                                      v[:, :, :kept].contiguous(), w_out, b_out, eps=eps)
        fault = rel_l2(short, ref)
        if not rel <= K5_REL_L2_TOLERANCE or not weights_rel <= K5_REL_L2_TOLERANCE:
            raise AssertionError(f"K5 at {rows} rows disagrees with its plain version: rel L2 {rel}, weights "
                                 f"{weights_rel}")
        if not sum_err <= K5_WEIGHT_SUM_TOLERANCE:
            raise AssertionError(f"K5's weight rows at {rows} rows do not sum to 1: {sum_err}")
        if not fault > K5_REL_L2_TOLERANCE:
            raise AssertionError(f"K5's limit at {rows} rows would pass a softmax without its last partial tile: "
                                 f"{fault}")
        bytes_moved = (2 * (2 * rows * d + 2 * d + 2 * heads * d * head_dim + heads * head_dim + d
                            + 2 * rows * heads * head_dim * s_len) + 4 * heads * rows * s_len)
        flops = 2.0 * rows * d * heads * head_dim * 2 + 4.0 * rows * heads * head_dim * s_len
        sets = [args] + [operands(rows) for _ in range(copies_for(bytes_moved) - 1)]
        bound, bound_by = bound_ms(bytes_moved=bytes_moved, flops=flops, peak_flops=PEAK_BF16_FLOPS)
        return {"sets": sets, "bytes_moved": bytes_moved, "cluster": cluster, "same_bits": same_bits,
                "max_abs_err": err, "rel_l2_err": rel, "weights_rel_l2_err": weights_rel, "weight_sum_err": sum_err,
                "short_rel_l2_err": short_rel, "short_weight_sum_err": short_sum_err, "short_chunks": short_chunks,
                "fault": fault, "bound_ms": bound, "bound_by": bound_by,
                "ms": rotating_ms(lambda *a: dsk.cross_attention_step(*a, eps=eps), sets),
                "plain_ms": rotating_ms(lambda *a: dsk.cross_attention_step_reference(*a, eps=eps), sets)}

    # Two rows (two windows decoded in lockstep) and one (a clip of 30 s or less: the default request).
    checks = {rows: check(rows) for rows in (2, 1)}
    two, rows = checks[2], 2

    def unfused(x, scale, bias, w_q, b_q, k, v, w_out, b_out):
        h = wd._layer_norm(_Affine(scale[0], bias[0]), x[:, None], eps)
        q_lin = _Affine(w_q, b_q.reshape(-1))
        q = wd._split_heads(wd._dense(q_lin, h, torch.bfloat16), heads)
        out, attn = wd._attend_cross_step(q, k, v, compute_dtype=torch.bfloat16)
        return x + wd._dense(_Affine(w_out.reshape(heads * head_dim, d).t(), b_out[0]), out.reshape(rows, -1),
                             torch.bfloat16), attn

    # The unfused route reads the Q projection as an nn.Linear weight (out, in).
    unfused_sets = [(a[0], a[1], a[2], a[3].permute(0, 2, 1).reshape(heads * head_dim, d).contiguous(), *a[4:])
                    for a in two["sets"]]
    unfused_ms = rotating_ms(unfused, unfused_sets)
    for label, count in (("K5", 2), ("K5-one-row", 1)):
        reading = checks[count]
        say(label, shape=f"x({count},{d}) K/V({count},{heads},{head_dim},{s_len}) bf16", cluster=reading["cluster"],
            chunks=json.dumps([stop - start for start, stop in dsk.chunk_bounds(s_len, reading["cluster"])]),
            same_bits=reading["same_bits"], max_abs_err=reading["max_abs_err"], rel_l2_err=reading["rel_l2_err"],
            weights_rel_l2_err=reading["weights_rel_l2_err"], weight_sum_err=reading["weight_sum_err"],
            short_s=short_s, short_chunks=json.dumps(reading["short_chunks"]),
            short_rel_l2_err=reading["short_rel_l2_err"], short_weight_sum_err=reading["short_weight_sum_err"],
            rel_l2_tolerance=K5_REL_L2_TOLERANCE, tail_fault_rel_l2=reading["fault"], ms=f"{reading['ms']:.4f}",
            plain_ms=f"{reading['plain_ms']:.4f}", bound_ms=f"{reading['bound_ms']:.4f}",
            bound_by=reading["bound_by"], gb_per_s=f"{reading['bytes_moved'] / reading['ms'] / 1e6:.1f}")
    say("K5-routes", rows=rows, unfused_ms=f"{unfused_ms:.4f}")
    return {
        "name": "cross_attention_step",
        "route": "cuda",
        "source": "ser_tpu_torch/csrc/decode_step.cu",
        "replaces": "ser_tpu/ops/decode_step_kernels.py:269",
        "max_abs_err": max(reading["max_abs_err"] for reading in checks.values()),
        "rel_l2_err": max(reading["rel_l2_err"] for reading in checks.values()),
        "weights_rel_l2_err": max(reading["weights_rel_l2_err"] for reading in checks.values()),
        "weight_sum_err": max(reading["weight_sum_err"] for reading in checks.values()),
        "same_bits": all(reading["same_bits"] for reading in checks.values()),
        "cluster": two["cluster"],
        "tolerance": K5_REL_L2_TOLERANCE,
        "tolerance_on": "rel_l2_err",
        "ms": two["ms"],
        "plain_ms": two["plain_ms"],
        "unfused_ms": unfused_ms,
        "bound_ms": two["bound_ms"],
        "bound_by": two["bound_by"],
        "library_ms": None,
        "one_row": {**_one_row(checks[1]), "cluster": checks[1]["cluster"]},
    }


def _encoder_flops(config, n_windows: int) -> float:
    """2·MACs of the conv stem and the per-layer matmuls at 1500 states (bench.py's count)."""
    t_mel, t = 3000, 1500
    d, layers, ffn = config.d_model, config.encoder_layers, 4 * config.d_model
    macs_conv = t_mel * 3 * config.n_mels * d + t * 3 * d * d
    macs_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * ffn
    return 2.0 * (macs_conv + layers * macs_layer) * n_windows


_KERNEL_GROUPS = (
    ("K3 ln_qkv_project", ("ln_qkv_kernel",)),
    ("K4 self_attend_and_out", ("attend_cluster_kernel<false>",)),
    ("K5 cross_attention_step", ("attend_cluster_kernel<true>",)),
    ("K2 flash_attention", ("flash_attention_fwd_kernel",)),
    ("K2-f32 flash_attention_f32", ("flash_attention_f32_kernel",)),
    ("K2-bwd flash_attention_bwd", ("flash_attention_bwd",)),
    ("K1 stft_power_mel_log", ("power_mel_log_kernel",)),  # both forms
    # The fast profile's DSP (no kernel of the port's own): cuFFT, sorts, medians.
    ("fft", ("fft", "FFT", "spRadix")),
    ("sort", ("sort", "Sort", "radix", "bitonic")),
    ("median", ("median", "Median", "kthvalue")),
    ("conv", ("cudnn", "conv", "fprop", "implicit_convolve")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel", "copy", "Memset", "Memcpy")),
)


def _kernel_group(name: str) -> str:
    for group, needles in _KERNEL_GROUPS:
        if any(needle in name for needle in needles):
            return group
    return "other"


#: Device ms by kernel group of the last profiled run (filled by :func:`_profile`).
_LAST_PROFILE_GROUPS: dict[str, float] = {}


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals in microseconds, in ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def _profile(run, label: str) -> str:
    """Device time of one ``run()`` by kernel group, and the device's busy share.

    The profiler runs one warm-up step first, so the profiled step's wall
    time holds no profiler start-up. Only device events (kernels, memsets,
    copies) are summed. The busy share is the union of their intervals over
    the wall time: kernels that overlap (on two streams, or a copy beside a
    kernel) count once, so it cannot pass 1, as the sum of their times can.
    Informational: where the profiler cannot trace the card, it says so and
    the run goes on (the phase's numbers come from the host clock and CUDA
    events).
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced_ready(prof) -> None:
        traced.setdefault("events", prof.key_averages())
        traced.setdefault("device_events", [
            (event.name, event.time_range.start, event.time_range.end)
            for event in prof.events() if event.device_type == DeviceType.CUDA
        ])

    # A trace that starts right after another one ended (CUPTI torn down, see
    # TEARDOWN_CUPTI above) may hold no device events: trace once more.
    for _attempt in range(2):
        traced = {}
        try:
            with profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=traced_ready,
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
    groups = _LAST_PROFILE_GROUPS
    groups.clear()
    for event in kernels:
        group = _kernel_group(event.key)
        groups[group] = groups.get(group, 0.0) + event.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    rows = [[e.key[:72], e.count, round(e.self_device_time_total / 1e3, 3)] for e in top]
    say(f"{label}-kernels", top=json.dumps(rows))
    shares = ", ".join(f"{g}:{ms:.3f}ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    # The device events summed above, by name: the trace's device timeline also holds the
    # profiler step's own annotation, which spans the whole step.
    names = {event.key for event in kernels}
    intervals = [(start, end) for name, start, end in traced.get("device_events", []) if name in names]
    busy = f"{_union_ms(intervals) / wall_ms:.4f}" if intervals else "unavailable"
    return (f"wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} busy={busy} "
            f"kernel_sum_over_wall={device_ms / wall_ms:.4f} groups=[{shares}]")


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

    for counter in (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER):
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    for _ in range(repeats):
        states = wm.encode_mel_chunks(encoder, chunks)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - started
    k1_per, k2_per = log_mel.FUSED_COUNTER.launches / repeats, attention.COUNTER.launches / repeats
    spectrum_per = log_mel.COUNTER.launches / repeats
    audio_s_per_s = repeats * n_windows * 30.0 / elapsed
    mfu = _encoder_flops(config, n_windows) * repeats / elapsed / PEAK_BF16_FLOPS
    say("encoder", windows=n_windows, repeats=repeats, seconds=f"{elapsed:.4f}",
        ms_per_encode=f"{elapsed / repeats * 1e3:.2f}", audio_s_per_s=f"{audio_s_per_s:.1f}",
        mfu=f"{mfu:.4f}", k1_per_encode=k1_per, k1_spectrum_form_per_encode=spectrum_per, k2_per_encode=k2_per,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if (k1_per, spectrum_per, k2_per) != (1, 0, config.encoder_layers):
        raise AssertionError(f"launches per encode K1 fused={k1_per} K1 spectrum={spectrum_per} K2={k2_per}, "
                             "expected 1, 0 and 32")
    breakdown = _profile(lambda: wm.encode_mel_chunks(encoder, chunks), "encoder")
    say("encoder-profile", detail=breakdown)
    # The front end inside the encode (log-mel, floor and affine), and the same with the
    # route it replaced: the matmul STFT and K1's spectrum form.
    fb = torch.from_numpy(log_mel._mel_fb_t(wm.SAMPLE_RATE, wm.N_FFT, config.n_mels)).to(cuda)
    frontend = interleaved_ms({
        "fused": lambda: wm.log_mel_spectrogram(chunks, config.n_mels),
        "old_route": lambda: log_mel.normalize_log_mel(log_mel.power_mel_log(
            log_mel.stft(chunks, wm.N_FFT, wm.HOP_LENGTH).contiguous(), fb, wm.CHUNK_FRAMES)),
    })
    say("encoder-frontend", ms=spread(frontend["fused"]), old_route_ms=spread(frontend["old_route"]),
        ms_per_encode=f"{elapsed / repeats * 1e3:.2f}")
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
    return {"k1_per_encode": k1_per, "k1_spectrum_form_per_encode": spectrum_per, "k2_per_encode": k2_per}


class SyntheticTokenizer:
    """large-v3's special-token ids, and one word per token (``bench.py``'s stand-in, ``bench.py:451-465``).

    The phases that build ``WhisperForTranscription`` by hand (``transcribe``,
    ``beam``, ``int8-decode``, ``separate``) keep it, because one word per
    token makes their word timing (the DTW and the word count) the same work
    as ``bench.py``'s transcript lane on the same token streams; a byte-level
    vocabulary would join random tokens into fewer words. Phase
    ``transcript-infer`` stages tokenizer files (``write_whisper_tokenizer_files``)
    that the port's own tokenizer reads through ``from_pretrained_dir``.
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


#: Whisper's published language order (``whisper/tokenizer.py``; large-v3 adds ``yue``): 100 codes, from 50259.
WHISPER_LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl", "ar", "sv", "it", "id", "hi",
    "fi", "vi", "he", "uk", "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy",
    "ne", "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl",
    "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su", "yue",
)
#: Multi-byte UTF-8 characters the synthetic vocabulary's tokens are cut from.
_VOCAB_WIDE_CHARS = ("é", "ü", "ñ", "ß", "中", "文", "日", "本", "한", "😀")


def whisper_added_tokens(n_vocab: int = 50257) -> list[str]:
    """The 1609 added tokens of large-v3's tokenizer, in id order from ``n_vocab``."""
    tokens = ["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{code}|>" for code in WHISPER_LANGUAGES]
    tokens += ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>",
               "<|notimestamps|>"]
    return tokens + [f"<|{index * 0.02:.2f}|>" for index in range(1501)]


def write_whisper_tokenizer_files(model_dir: Path, *, n_vocab: int = 50257, seed: int = 0) -> dict[str, int]:
    """Tokenizer files in large-v3's published layout, with a synthetic vocabulary.

    ``vocab.json``: the 256 byte tokens under GPT-2's ``bytes_to_unicode``,
    then ``n_vocab - 256`` distinct multi-byte strings drawn from ``seed``
    (ASCII letters and pieces of multi-byte characters, half of them with the
    ``Ġ`` space prefix), so that ids can split a UTF-8 sequence; ``merges.txt``
    (its header: nothing is encoded); ``tokenizer_config.json`` with the 1609
    added tokens at large-v3's ids (``added_tokens_decoder``, from
    ``n_vocab``), ``<|endoftext|>`` as unk/bos/eos and
    ``clean_up_tokenization_spaces`` on, as published. Returns the vocabulary.
    """
    import numpy as np

    from ser_tpu_torch.models.whisper_tokenizer import bytes_to_unicode

    byte_encoder = bytes_to_unicode()
    vocab = {char: index for index, char in enumerate(byte_encoder.values())}
    rng = np.random.default_rng(seed)
    letters = [bytes([code]) for code in range(ord("a"), ord("z") + 1)]
    wide = [char.encode("utf-8") for char in _VOCAB_WIDE_CHARS]
    while len(vocab) < n_vocab:
        units = [wide[rng.integers(len(wide))] if rng.random() < 0.15 else letters[rng.integers(len(letters))]
                 for _ in range(int(rng.integers(2, 7)))]
        raw = b"".join(units)
        if rng.random() < 0.2:  # cut inside a character: a token that ends or starts mid-sequence
            raw = raw[: int(rng.integers(1, len(raw)))] if rng.random() < 0.5 else raw[int(rng.integers(1, len(raw))):]
        if rng.random() < 0.5:
            raw = b" " + raw
        vocab.setdefault("".join(byte_encoder[byte] for byte in raw), len(vocab))
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (model_dir / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    added = {str(n_vocab + index): {"content": token, "lstrip": False, "normalized": False, "rstrip": False,
                                    "single_word": False, "special": True}
             for index, token in enumerate(whisper_added_tokens(n_vocab))}
    (model_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "WhisperTokenizer", "added_tokens_decoder": added, "unk_token": "<|endoftext|>",
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>", "clean_up_tokenization_spaces": True,
        "errors": "replace", "model_max_length": 1000000000000000019884624838656,
    }, ensure_ascii=False), encoding="utf-8")
    return vocab


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
    dsk.LN_QKV_COUNTER.launches = 0
    decode(True, budget=DECODE_PROFILE_BUDGET)
    profiled_steps = dsk.LN_QKV_COUNTER.launches / config.decoder_layers  # K3 runs once a layer a step
    breakdown = _profile(lambda: decode(True, budget=DECODE_PROFILE_BUDGET), "decode")
    k3_step_ms = _LAST_PROFILE_GROUPS.get("K3 ln_qkv_project", 0.0) / profiled_steps if profiled_steps else 0.0
    say("decode-profile", route="fused", budget=DECODE_PROFILE_BUDGET, steps=profiled_steps,
        k3_device_ms_per_step=f"{k3_step_ms:.4f}", detail=breakdown)
    breakdown = _profile(lambda: decode(False, budget=DECODE_PROFILE_BUDGET), "decode-unfused")
    say("decode-profile", route="unfused", budget=DECODE_PROFILE_BUDGET, detail=breakdown)
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
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, *dsk.COUNTERS)
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
        if (launches["stft_power_mel_log"], launches["power_mel_log"], launches["flash_attention_fwd"]) != (1, 0, 32):
            raise AssertionError(f"transcribe launches {launches}: expected K1 fused=1, K1 spectrum=0, K2=32 "
                                 "for one 2-window encode")
        if not (k3 == k4 == k5 and k3 > 0 and k3 % 32 == 0):
            raise AssertionError(f"transcribe launches {launches}: K3-K5 did not run 32 times per step")
    model.config = config
    wm.encode_mel_chunks, word_timing.word_timings_from_matrix = encode, word_timings
    return {"launches": main_launches, "latency": results}


def _write_head_envelope(
    path: Path,
    feature_size: int,
    *,
    backend_id: str = "jax_whisper_encoder",
    profile: str = "accurate",
    model_id: str = "openai/whisper-large-v3",
) -> None:
    """A ser_tpu v3 artifact envelope holding a seeded ser_tpu_mlp head (feature_size → 300 → 8)."""
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
        "backend_id": backend_id,
        "profile": profile,
        "pooling_strategy": "mean_std",
        "backend_model_id": model_id,
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


def _check_segments(execution, clip: Path, seconds: float, backend_id: str) -> None:
    """The segments cover the clip without gaps, from the expected backend, with finite probabilities."""
    segments = execution.detailed_result.segments
    if execution.backend_id != backend_id:
        raise AssertionError(f"backend_id {execution.backend_id!r}, expected {backend_id!r}")
    if not segments or abs(segments[0].start_seconds) > 1e-6 or abs(segments[-1].end_seconds - seconds) > 0.05:
        raise AssertionError(f"segments of {clip.name} do not cover it: {segments[:1]}..{segments[-1:]}")
    for before, after in zip(segments, segments[1:]):
        if abs(after.start_seconds - before.end_seconds) > 1e-6:
            raise AssertionError(f"gap between segments in {clip.name}")
    probabilities = [p for frame in execution.detailed_result.frames for p in frame.probabilities.values()]
    if not all(math.isfinite(p) for p in probabilities):
        raise AssertionError(f"non-finite probabilities for {clip.name}")


def phase_infer() -> dict:
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel, resample

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

        counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, resample.COUNTER)
        for counter in counters:
            counter.launches = 0
        executions = [run(clip) for clip, _ in clips]
        launches = {c.name: c.launches for c in counters}
        warm = [run(clip)[1] for clip, _ in clips]

    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        segments = execution.detailed_result.segments
        _check_segments(execution, clip, seconds, "jax_whisper_encoder")
        say("infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}",
            warm_latency_s=f"{warm_s:.4f}", frames=len(execution.detailed_result.frames),
            segments=len(segments), labels=json.dumps(sorted({s.emotion for s in segments})))
    say("infer-launches", **launches)
    expected = {"stft_power_mel_log": len(clips), "power_mel_log": 0, "flash_attention_fwd": 32 * len(clips),
                "resample_rows": len(clips)}
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")
    return launches


def _wav2vec2_flops(config, samples: int) -> dict[str, float]:
    """FLOP of one chunk through the encoder, 2 per multiply-add, by part."""
    frames, length, channels = [], samples, 1
    conv = 0.0
    for dim, kernel, stride in zip(config.conv_dim, config.conv_kernel, config.conv_stride):
        length = (length - kernel) // stride + 1
        conv += 2.0 * length * dim * channels * kernel
        channels = dim
        frames.append(length)
    t, d, ffn = frames[-1], config.hidden_size, config.intermediate_size
    projection = 2.0 * t * channels * d
    positional = 2.0 * t * d * (d // config.num_conv_pos_embedding_groups) * config.num_conv_pos_embeddings
    layer_products = config.num_hidden_layers * 2.0 * (4 * t * d * d + 2 * t * d * ffn)
    attention_flops = config.num_hidden_layers * 4.0 * t * t * d
    return {"conv_front_end": conv, "feature_projection": projection, "positional_conv": positional,
            "layer_products": layer_products, "attention": attention_flops}


def _medium_layers_check(chunk, length: int, config=None, state=None) -> dict:
    """2-layer full-width wav2vec2-class encoder: card bf16 and card float32 against CPU float32, same weights.

    Default: XLS-R 300M's widths with seeded weights; or the given config
    (cut to 2 layers) and state (the layers past 2 dropped).
    """
    import dataclasses

    import numpy as np
    import torch

    from ser_tpu_torch.models import wav2vec2 as w2v
    from ser_tpu_torch.models.param_utils import cast_state_bf16

    if config is None:
        config = w2v.Wav2Vec2Config(num_hidden_layers=2)
        state = w2v.random_wav2vec2_state(config, seed=1, device="cpu")
    else:
        config = dataclasses.replace(config, num_hidden_layers=2)
        kept = {f"layers.{i}." for i in range(2)}
        state = {name: tensor.float().cpu() for name, tensor in state.items()
                 if not name.startswith("layers.") or name.startswith(tuple(kept))}
    frames = config.frames_for_samples(chunk.shape[1])
    mask = torch.from_numpy(np.arange(frames)[None, :] < config.frames_for_samples(length))
    on_cpu = w2v.build_wav2vec2_encoder(config, state, device="cpu")
    with torch.no_grad():
        reference = on_cpu(chunk.cpu(), mask)
    del on_cpu
    readings = {}
    for label, dtype, weights in (("bf16", torch.bfloat16, cast_state_bf16(state)), ("float32", torch.float32, state)):
        encoder = w2v.build_wav2vec2_encoder(config, weights, device="cuda", compute_dtype=dtype)
        with torch.no_grad():
            out = encoder(chunk, mask.cuda()).cpu()
        readings[label] = {"rel_l2": rel_l2(out, reference), "max_abs": (out - reference).abs().max().item()}
        del encoder
    return readings


def phase_medium_encoder() -> dict:
    """XLS-R 300M at full width (24 layers, seeded random weights, bf16) on 8 chunks of 30 s."""
    import numpy as np
    import torch

    from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import wav2vec2 as w2v

    config = w2v.Wav2Vec2Config()
    cuda = torch.device("cuda")
    started = time.perf_counter()
    backend = XlsrBackend(model_id=MEDIUM_MODEL_ID, cache_root=REPO / "build", device=cuda, dtype="bfloat16",
                          config=config, state=w2v.random_wav2vec2_state(config, seed=0, device=cuda))
    torch.cuda.synchronize()
    say("medium-encoder-build", seconds=f"{time.perf_counter() - started:.2f}",
        params_m=f"{sum(p.numel() for p in backend._model.parameters()) / 1e6:.1f}")

    n_chunks, samples, repeats = 8, 30 * 16000, 3
    rng = np.random.default_rng(0)
    batch = (0.1 * rng.standard_normal((n_chunks, samples))).astype(np.float32)
    lengths = np.full(n_chunks, samples, dtype=np.int32)
    frames = config.frames_for_samples(samples)
    states = backend._encode_batch(batch, lengths)  # warm-up
    torch.cuda.synchronize()
    if states.shape != (n_chunks, frames, config.hidden_size) or not torch.isfinite(states).all():
        raise AssertionError(f"medium encoder output {tuple(states.shape)} is not finite/of the right shape")

    attention.COUNTER.launches = 0
    attention.F32_COUNTER.launches = 0
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    for _ in range(repeats):
        states = backend._encode_batch(batch, lengths)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - started
    k2_per, f32_per = attention.COUNTER.launches / repeats, attention.F32_COUNTER.launches / repeats
    flops = {part: value * n_chunks for part, value in _wav2vec2_flops(config, samples).items()}
    total = sum(flops.values())
    say("medium-encoder", chunks=n_chunks, seconds_per_chunk=30, frames=frames, repeats=repeats,
        ms_per_encode=f"{elapsed / repeats * 1e3:.2f}", audio_s_per_s=f"{repeats * n_chunks * 30.0 / elapsed:.1f}",
        mfu=f"{total * repeats / elapsed / PEAK_BF16_FLOPS:.4f}", tflop_per_encode=f"{total / 1e12:.3f}",
        flop_by_part=json.dumps({part: f"{value / 1e12:.3f}T" for part, value in flops.items()}),
        k2_per_encode=k2_per, k2_f32_per_encode=f32_per,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if (k2_per, f32_per) != (config.num_hidden_layers, 0):
        raise AssertionError(f"launches per bf16 encode K2={k2_per} K2-f32={f32_per}, expected 24 and 0")
    breakdown = _profile(lambda: backend._encode_batch(batch, lengths), "medium-encoder")
    say("medium-encoder-profile", detail=breakdown)
    chunk = torch.from_numpy(batch[:1]).to(cuda)
    del backend, states
    torch.cuda.empty_cache()

    # One float32 encode of the same batch (the float32 request's and the retry's path):
    # its time, its K2-f32 launches, and K2-f32's share of its device time.
    backend = XlsrBackend(model_id=MEDIUM_MODEL_ID, cache_root=REPO / "build", device=cuda, dtype="float32",
                          config=config, state=w2v.random_wav2vec2_state(config, seed=0, device=cuda))
    states = backend._encode_batch(batch, lengths)  # warm-up
    torch.cuda.synchronize()
    attention.F32_COUNTER.launches = 0
    started = time.perf_counter()
    states = backend._encode_batch(batch, lengths)
    torch.cuda.synchronize()
    f32_seconds = time.perf_counter() - started
    f32_launches = attention.F32_COUNTER.launches
    if states.dtype != torch.float32 or not torch.isfinite(states).all() or f32_launches != config.num_hidden_layers:
        raise AssertionError(f"float32 encode: {states.dtype}, {f32_launches} K2-f32 launches (expected 24)")
    f32_breakdown = _profile(lambda: backend._encode_batch(batch, lengths), "medium-encoder-f32")
    k2_f32_ms = _LAST_PROFILE_GROUPS.get("K2-f32 flash_attention_f32", 0.0)
    device_ms = sum(_LAST_PROFILE_GROUPS.values())
    say("medium-encoder-f32", chunks=n_chunks, ms_per_encode=f"{f32_seconds * 1e3:.2f}",
        audio_s_per_s=f"{n_chunks * 30.0 / f32_seconds:.1f}", k2_f32_per_encode=f32_launches,
        k2_f32_device_ms=f"{k2_f32_ms:.3f}", k2_f32_share_of_device=f"{k2_f32_ms / device_ms if device_ms else 0.0:.4f}",
        detail=f32_breakdown)
    del backend, states
    torch.cuda.empty_cache()

    check = _medium_layers_check(chunk, 20 * 16000)
    say("medium-encoder-check", layers=2, d_model=config.hidden_size, valid_seconds=20,
        bf16_rel_l2=f"{check['bf16']['rel_l2']:.5f}", bf16_bound=MEDIUM_BF16_REL_L2_BOUND,
        bf16_max_abs=f"{check['bf16']['max_abs']:.4f}", float32_max_abs=f"{check['float32']['max_abs']:.3g}",
        float32_bound=MEDIUM_F32_MAX_ABS_BOUND, float32_rel_l2=f"{check['float32']['rel_l2']:.3g}")
    if not check["bf16"]["rel_l2"] <= MEDIUM_BF16_REL_L2_BOUND:
        raise AssertionError(f"card bf16 XLS-R disagrees with the CPU: {check['bf16']}")
    if not check["float32"]["max_abs"] <= MEDIUM_F32_MAX_ABS_BOUND:
        raise AssertionError(f"card float32 XLS-R disagrees with the CPU: {check['float32']}")
    return {"k2_per_encode": k2_per, "audio_s_per_s": repeats * n_chunks * 30.0 / elapsed}


def phase_medium_infer() -> dict:
    """``api.infer(profile="medium")`` at XLS-R 300M width: three clips cold and warm, device
    pooling, a float32 request, and a float32 retry after a planted non-finite encode."""
    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.pool.device_pool import is_device_embeddings
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.runtime import profile_execution
    from ser_tpu_torch.models import attention

    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    pooled = []
    host_pool = profile_execution.mean_std_pool

    def recording_pool(encoded, windows):
        features = host_pool(encoded, windows)
        on_card = is_device_embeddings(encoded.embeddings) and encoded.embeddings.is_cuda
        pooled.append((on_card, features))
        return features

    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        artifact = root / "models" / profile_artifact_file_name(profile="medium", model_id=MEDIUM_MODEL_ID)
        _write_head_envelope(artifact, feature_size=2 * 1024, backend_id="jax_xlsr", profile="medium",
                             model_id=MEDIUM_MODEL_ID)
        clips = []
        for index, seconds in enumerate((10.0, 45.0, 75.0)):
            clip = root / f"clip_{int(seconds)}s.wav"
            _write_clip(clip, seconds, 48000, seed=10 + index)
            clips.append((clip, seconds))
        os.environ["SER_ALLOW_RANDOM_INIT"] = "1"
        os.environ["SER_RANDOM_INIT_SIZE"] = "full"
        env = {"SER_ENABLE_MEDIUM_PROFILE": "1", "SER_MODELS_FOLDER": str(root / "models"),
               "SER_CACHE_DIR": str(root / "cache")}
        settings = build_settings(env)

        def run(clip: Path, run_settings=settings):
            started = time.perf_counter()
            execution = api.infer(clip, profile="medium", include_transcript=False, settings=run_settings)
            torch.cuda.synchronize()
            return execution, time.perf_counter() - started

        attention.COUNTER.launches = 0
        attention.F32_COUNTER.launches = 0
        launches = {}
        executions = [run(clip) for clip, _ in clips]
        launches["bf16_requests"] = {"flash_attention_fwd": attention.COUNTER.launches,
                                     "flash_attention_f32": attention.F32_COUNTER.launches}
        warm = [run(clip)[1] for clip, _ in clips]

        # Device pooling against host pooling on the 45 s clip, the head's inputs recorded.
        profile_execution.mean_std_pool = recording_pool
        try:
            run(clips[1][0])
            os.environ["SER_DEVICE_POOLING"] = "1"
            try:
                pooled_execution, pooled_s = run(clips[1][0])
            finally:
                del os.environ["SER_DEVICE_POOLING"]
        finally:
            profile_execution.mean_std_pool = host_pool
        (host_on_card, host_features), (device_on_card, device_features) = pooled
        # Per window, relative to the window's largest feature: an element-wise
        # ratio is ill-posed for a mean near zero (a 4e-8 difference on a 4e-5 mean).
        pooling_diff = np.abs(device_features - host_features)
        pooling_rel = float((pooling_diff.max(axis=1) / np.abs(host_features).max(axis=1)).max())
        elementwise_rel = float((pooling_diff / (np.abs(host_features) + 1e-9)).max())

        # SER_TORCH_DTYPE=float32: a float32 backend, its attention through K2-f32.
        before = attention.F32_COUNTER.launches
        f32_execution, f32_s = run(clips[1][0], build_settings({**env, "SER_TORCH_DTYPE": "float32"}))
        launches["float32_request"] = attention.F32_COUNTER.launches - before

        # A non-finite first bf16 encode: the retry runs in float32, and the backend stays so.
        backend = encoders.build_encoder_backend("medium", settings)
        calls = []
        encode = backend._encode_batch

        def planted(batch, lengths):
            out = encode(batch, lengths)
            calls.append(str(backend.dtype))
            return out * float("nan") if len(calls) == 1 else out

        backend._encode_batch = planted
        before = attention.F32_COUNTER.launches
        retry_execution, retry_s = run(clips[0][0])
        launches["retry_request"] = attention.F32_COUNTER.launches - before
        launches["per_float32_encode"] = launches["retry_request"] / max(1, calls.count("torch.float32"))
        launches["total"] = {"flash_attention_fwd": attention.COUNTER.launches,
                             "flash_attention_f32": attention.F32_COUNTER.launches}

    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        _check_segments(execution, clip, seconds, "jax_xlsr")
        say("medium-infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}",
            warm_latency_s=f"{warm_s:.4f}", frames=len(execution.detailed_result.frames),
            segments=len(execution.detailed_result.segments),
            labels=json.dumps(sorted({s.emotion for s in execution.detailed_result.segments})))
    for label, execution, clip_index in (("device-pooling", pooled_execution, 1), ("float32", f32_execution, 1),
                                         ("retry", retry_execution, 0)):
        _check_segments(execution, clips[clip_index][0], clips[clip_index][1], "jax_xlsr")
    say("medium-infer-pooling", clip=clips[1][0].name, latency_s=f"{pooled_s:.4f}", host_on_card=host_on_card,
        device_on_card=device_on_card, max_rel_diff_per_window=f"{pooling_rel:.3g}", bound=DEVICE_POOLING_REL_BOUND,
        max_abs_diff=f"{pooling_diff.max():.3g}", max_elementwise_rel_diff=f"{elementwise_rel:.3g}")
    say("medium-infer-float32", clip=clips[1][0].name, latency_s=f"{f32_s:.4f}",
        k2_f32_launches=launches["float32_request"])
    say("medium-infer-retry", clip=clips[0][0].name, latency_s=f"{retry_s:.4f}", encode_dtypes=json.dumps(calls),
        k2_f32_launches=launches["retry_request"], backend_dtype_after=str(backend.dtype))
    say("medium-infer-launches", **{key: json.dumps(value) for key, value in launches.items()})
    layers = 24
    if launches["bf16_requests"] != {"flash_attention_fwd": layers * len(clips), "flash_attention_f32": 0}:
        raise AssertionError(f"bf16 medium requests launched {launches['bf16_requests']}, expected K2={layers * 3}")
    if not (device_on_card and not host_on_card and pooling_rel < DEVICE_POOLING_REL_BOUND):
        raise AssertionError(f"device pooling: on card {device_on_card}, host {host_on_card}, rel {pooling_rel}")
    if launches["float32_request"] != layers:
        raise AssertionError(f"the float32 request launched K2-f32 {launches['float32_request']} times, expected 24")
    if calls != ["torch.bfloat16", "torch.float32"] or launches["per_float32_encode"] != layers:
        raise AssertionError(f"the float32 retry did not run through K2-f32: {calls}, {launches['retry_request']}")
    if backend.dtype != torch.float32:
        raise AssertionError("the backend did not stay float32 after its retry")
    return launches


def _stage_emotion2vec(model_dir: Path) -> dict:
    """Writes a full-width FunASR-layout ``model.pt`` in bf16 (seeded weights, std 1/√fan_in).

    The fairseq data2vec 2.0 audio naming: a 7-conv layer-norm front end 512
    wide (no conv bias), ``project_features.{1,2}`` (LayerNorm, 512 → 1024),
    5 positional blocks of kernel 19 in 16 groups, 24 AltBlocks (prenet then
    trunk) with layer scales, the final norm, and decoder and EMA tensors the
    converter must skip.
    """
    import torch

    generator = torch.Generator(device="cuda").manual_seed(11)

    def normal(*shape, fan_in: int):
        return (torch.randn(shape, generator=generator, device="cuda") / math.sqrt(fan_in)).to(torch.bfloat16)

    def const(value: float, *shape):
        return torch.full(shape, value, dtype=torch.bfloat16, device="cuda")

    d, ffn, audio = 1024, 4096, "modality_encoders.AUDIO."
    state = {}
    channels = 1
    for i, kernel in enumerate((10, 3, 3, 3, 3, 2, 2)):
        base = f"{audio}local_encoder.conv_layers.{i}"
        state[f"{base}.0.weight"] = normal(512, channels, kernel, fan_in=channels * kernel)
        state[f"{base}.2.1.weight"], state[f"{base}.2.1.bias"] = const(1.0, 512), const(0.0, 512)
        channels = 512
    state[f"{audio}project_features.1.weight"], state[f"{audio}project_features.1.bias"] = const(1.0, 512), const(0.0, 512)
    state[f"{audio}project_features.2.weight"] = normal(d, 512, fan_in=512)
    state[f"{audio}project_features.2.bias"] = const(0.0, d)
    width = d // RESEARCH_POS_GROUPS
    for i in range(RESEARCH_POS_DEPTH):
        base = f"{audio}relative_positional_encoder.{i}.0"
        state[f"{base}.weight"] = normal(d, width, RESEARCH_POS_KERNEL, fan_in=width * RESEARCH_POS_KERNEL)
        state[f"{base}.bias"] = const(0.0, d)
    for block in range(RESEARCH_BLOCKS):
        prenet = block < RESEARCH_PRENET_BLOCKS
        base = f"{audio}context_encoder.blocks.{block}" if prenet else f"blocks.{block - RESEARCH_PRENET_BLOCKS}"
        for norm in ("norm1", "norm2"):
            state[f"{base}.{norm}.weight"], state[f"{base}.{norm}.bias"] = const(1.0, d), const(0.0, d)
        state[f"{base}.attn.qkv.weight"], state[f"{base}.attn.qkv.bias"] = normal(3 * d, d, fan_in=d), const(0.0, 3 * d)
        state[f"{base}.attn.proj.weight"], state[f"{base}.attn.proj.bias"] = normal(d, d, fan_in=d), const(0.0, d)
        state[f"{base}.mlp.fc1.weight"], state[f"{base}.mlp.fc1.bias"] = normal(ffn, d, fan_in=d), const(0.0, ffn)
        state[f"{base}.mlp.fc2.weight"], state[f"{base}.mlp.fc2.bias"] = normal(d, ffn, fan_in=ffn), const(0.0, d)
        state[f"{base}.gamma_1"], state[f"{base}.gamma_2"] = const(0.5, d), const(0.5, d)
    state["norm.weight"], state["norm.bias"] = const(1.0, d), const(0.0, d)
    state["decoder.blocks.0.0.weight"] = normal(d, d, 5, fan_in=d * 5)
    state["_ema.blocks.0.norm1.weight"] = const(1.0, d)
    state = {name: tensor.cpu() for name, tensor in state.items()}
    model_dir.mkdir(parents=True, exist_ok=True)
    torch.save(state, model_dir / "model.pt")
    return {"tensors": len(state), "gb": sum(t.numel() * t.element_size() for t in state.values()) / 1e9}


def phase_research_encoder(cache_root: Path) -> dict:
    """emotion2vec at full width from a staged bf16 FunASR ``model.pt``: convert, check the config,
    encode 8 chunks of 30 s, and a 2-layer card-vs-CPU check of the converted weights."""
    import numpy as np
    import torch

    from ser_tpu_torch._internal.repr.emotion2vec_backend import Emotion2VecBackend
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import wav2vec2 as w2v
    from ser_tpu_torch.models.emotion2vec_convert import load_funasr_emotion2vec_state

    phase_started = time.perf_counter()
    model_dir = cache_root / "model-cache" / "modelscope" / "hub" / RESEARCH_MODEL_ID
    started = time.perf_counter()
    staged = _stage_emotion2vec(model_dir)
    stage_s = time.perf_counter() - started
    started = time.perf_counter()
    config, state = load_funasr_emotion2vec_state(model_dir)
    convert_s = time.perf_counter() - started
    expected = w2v.Wav2Vec2Config(
        hidden_size=1024, num_hidden_layers=RESEARCH_BLOCKS, num_attention_heads=16, intermediate_size=4096,
        num_conv_pos_embeddings=RESEARCH_POS_DEPTH * RESEARCH_POS_KERNEL,
        num_conv_pos_embedding_groups=RESEARCH_POS_GROUPS, conv_pos_depth=RESEARCH_POS_DEPTH,
    )
    say("research-encoder-stage", tensors=staged["tensors"], model_pt_gb=f"{staged['gb']:.3f}",
        stage_s=f"{stage_s:.2f}", convert_s=f"{convert_s:.2f}", config_as_staged=config == expected,
        pos_kernel=max(3, config.num_conv_pos_embeddings // config.conv_pos_depth))
    if config != expected:
        raise AssertionError(f"inferred config {config} differs from the staged layout {expected}")

    cuda = torch.device("cuda")
    backend = Emotion2VecBackend(model_id=RESEARCH_MODEL_ID, cache_root=cache_root, device=cuda, dtype="bfloat16",
                                 config=config, state=state)
    n_chunks, samples, repeats = 8, 30 * 16000, 3
    rng = np.random.default_rng(0)
    batch = (0.1 * rng.standard_normal((n_chunks, samples))).astype(np.float32)
    lengths = np.full(n_chunks, samples, dtype=np.int32)
    frames = config.frames_for_samples(samples)
    states = backend._encode_batch(batch, lengths)  # warm-up
    torch.cuda.synchronize()
    if states.shape != (n_chunks, frames, config.hidden_size) or not torch.isfinite(states).all():
        raise AssertionError(f"research encoder output {tuple(states.shape)} is not finite/of the right shape")

    attention.COUNTER.launches = 0
    attention.F32_COUNTER.launches = 0
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    for _ in range(repeats):
        states = backend._encode_batch(batch, lengths)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - started
    k2_per, f32_per = attention.COUNTER.launches / repeats, attention.F32_COUNTER.launches / repeats
    # _wav2vec2_flops counts the positional part as one conv of num_conv_pos_embeddings
    # taps: the stack's 5 convs of 19 taps each are the same 95.
    flops = {part: value * n_chunks for part, value in _wav2vec2_flops(config, samples).items()}
    total = sum(flops.values())
    say("research-encoder", chunks=n_chunks, seconds_per_chunk=30, frames=frames, repeats=repeats,
        ms_per_encode=f"{elapsed / repeats * 1e3:.2f}", audio_s_per_s=f"{repeats * n_chunks * 30.0 / elapsed:.1f}",
        mfu=f"{total * repeats / elapsed / PEAK_BF16_FLOPS:.4f}", tflop_per_encode=f"{total / 1e12:.3f}",
        flop_by_part=json.dumps({part: f"{value / 1e12:.3f}T" for part, value in flops.items()}),
        k2_per_encode=k2_per, k2_f32_per_encode=f32_per,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if (k2_per, f32_per) != (RESEARCH_BLOCKS, 0):
        raise AssertionError(f"launches per bf16 encode K2={k2_per} K2-f32={f32_per}, expected 24 and 0")
    breakdown = _profile(lambda: backend._encode_batch(batch, lengths), "research-encoder")
    say("research-encoder-profile", detail=breakdown)
    chunk = torch.from_numpy(batch[:1]).to(cuda)
    del backend, states
    torch.cuda.empty_cache()

    check = _medium_layers_check(chunk, 20 * 16000, config=config, state=state)
    say("research-encoder-check", layers=2, d_model=config.hidden_size, pos_convs=config.conv_pos_depth,
        valid_seconds=20, bf16_rel_l2=f"{check['bf16']['rel_l2']:.5f}", bf16_bound=MEDIUM_BF16_REL_L2_BOUND,
        bf16_max_abs=f"{check['bf16']['max_abs']:.4f}", float32_max_abs=f"{check['float32']['max_abs']:.3g}",
        float32_bound=MEDIUM_F32_MAX_ABS_BOUND, float32_rel_l2=f"{check['float32']['rel_l2']:.3g}")
    if not check["bf16"]["rel_l2"] <= MEDIUM_BF16_REL_L2_BOUND:
        raise AssertionError(f"card bf16 emotion2vec disagrees with the CPU: {check['bf16']}")
    if not check["float32"]["max_abs"] <= MEDIUM_F32_MAX_ABS_BOUND:
        raise AssertionError(f"card float32 emotion2vec disagrees with the CPU: {check['float32']}")
    say("research-encoder-wall", seconds=f"{time.perf_counter() - phase_started:.1f}")
    return {"k2_per_encode": k2_per, "audio_s_per_s": repeats * n_chunks * 30.0 / elapsed}


def phase_research_infer(cache_root: Path) -> dict:
    """``api.infer(profile="accurate-research")`` on the staged checkpoint: three clips cold and
    warm behind the opened gate, one request with the gate shut, and a float32 retry."""
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError
    from ser_tpu_torch.models import attention

    phase_started = time.perf_counter()
    root = cache_root.parent
    artifact = root / "models" / profile_artifact_file_name(profile="accurate-research", model_id=RESEARCH_MODEL_ID)
    _write_head_envelope(artifact, feature_size=2 * 1024, backend_id="emotion2vec", profile="accurate-research",
                         model_id=RESEARCH_MODEL_ID)
    clips = []
    for index, seconds in enumerate((10.0, 45.0, 75.0)):
        clip = root / f"research_clip_{int(seconds)}s.wav"
        _write_clip(clip, seconds, 48000, seed=20 + index)
        clips.append((clip, seconds))
    # No consent recorded anywhere this run could read: only the env allowlist opens the gate.
    os.environ["SER_RESTRICTED_BACKENDS_CONSENT_FILE"] = str(root / "no_consent.json")
    env = {"SER_MODELS_FOLDER": str(root / "models"), "SER_CACHE_DIR": str(cache_root)}
    gated = {**env, "SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"}
    settings = build_settings(gated)

    def run(clip: Path, run_settings=settings):
        started = time.perf_counter()
        execution = api.infer(clip, profile="accurate-research", include_transcript=False, settings=run_settings)
        torch.cuda.synchronize()
        return execution, time.perf_counter() - started

    try:
        attention.COUNTER.launches = 0
        attention.F32_COUNTER.launches = 0
        launches = {}
        executions = [run(clip) for clip, _ in clips]
        launches["bf16_requests"] = {"flash_attention_fwd": attention.COUNTER.launches,
                                     "flash_attention_f32": attention.F32_COUNTER.launches}
        warm = [run(clip)[1] for clip, _ in clips]
        backend = encoders.build_encoder_backend("accurate-research", settings)
        loaded_depth = backend._config.conv_pos_depth

        refused = None
        try:
            run(clips[0][0], build_settings(env))
        except UnsupportedProfileError as err:
            refused = str(err)

        calls = []
        encode = backend._encode_batch

        def planted(batch, lengths):
            out = encode(batch, lengths)
            calls.append(str(backend.dtype))
            return out * float("nan") if len(calls) == 1 else out

        backend._encode_batch = planted
        before = attention.F32_COUNTER.launches
        retry_execution, retry_s = run(clips[0][0])
        launches["retry_request"] = attention.F32_COUNTER.launches - before
        launches["per_float32_encode"] = launches["retry_request"] / max(1, calls.count("torch.float32"))
    finally:
        del os.environ["SER_RESTRICTED_BACKENDS_CONSENT_FILE"]

    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        _check_segments(execution, clip, seconds, "emotion2vec")
        say("research-infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}",
            warm_latency_s=f"{warm_s:.4f}", frames=len(execution.detailed_result.frames),
            segments=len(execution.detailed_result.segments),
            labels=json.dumps(sorted({s.emotion for s in execution.detailed_result.segments})))
    _check_segments(retry_execution, clips[0][0], clips[0][1], "emotion2vec")
    say("research-infer-gate", flag_off_refused=refused is not None, loaded_pos_convs=loaded_depth,
        error=json.dumps((refused or "")[:100]))
    say("research-infer-retry", clip=clips[0][0].name, latency_s=f"{retry_s:.4f}", encode_dtypes=json.dumps(calls),
        k2_f32_launches=launches["retry_request"], backend_dtype_after=str(backend.dtype))
    say("research-infer-launches", **{key: json.dumps(value) for key, value in launches.items()})
    say("research-infer-wall", seconds=f"{time.perf_counter() - phase_started:.1f}")
    if loaded_depth != RESEARCH_POS_DEPTH:
        raise AssertionError(f"the backend did not load the staged checkpoint (positional depth {loaded_depth})")
    if refused is None:
        raise AssertionError("a request with the restricted-backend flag off was not refused")
    if launches["bf16_requests"] != {"flash_attention_fwd": RESEARCH_BLOCKS * len(clips), "flash_attention_f32": 0}:
        raise AssertionError(f"bf16 research requests launched {launches['bf16_requests']}, expected K2=72")
    if calls != ["torch.bfloat16", "torch.float32"] or launches["per_float32_encode"] != RESEARCH_BLOCKS:
        raise AssertionError(f"the float32 retry did not run through K2-f32: {calls}, {launches['retry_request']}")
    return launches


def _fast_families(card, cpu) -> dict[str, float]:
    """Per family, the card's largest error over its golden tolerance (above 1: outside)."""
    import numpy as np

    ratios = {}
    for family, (cols, atol) in FAST_FAMILIES.items():
        reference = cpu[:, cols].astype(np.float64)
        limit = FAST_RTOL * np.abs(reference) + atol * max(1.0, float(np.abs(reference).max()))
        ratios[family] = float((np.abs(card[:, cols] - reference) / limit).max())
    return ratios


def _check_fast_execution(execution, clip: Path, seconds: float) -> None:
    """Frames every second to the clip's end, merged segments in order, finite probabilities."""
    frames, segments = execution.detailed_result.frames, execution.detailed_result.segments
    if execution.backend_id != "handcrafted" or len(frames) != math.ceil(seconds):
        raise AssertionError(f"fast request on {clip.name}: backend {execution.backend_id}, {len(frames)} frames")
    if segments[0].start_seconds != 0.0 or abs(segments[-1].end_seconds - seconds) > 0.05:
        raise AssertionError(f"segments of {clip.name} do not cover it")
    if [s.emotion for s in segments] != [f.emotion for i, f in enumerate(frames) if i == 0 or frames[i - 1].emotion != f.emotion]:
        raise AssertionError(f"segments of {clip.name} are not the merged runs of its frames")
    if not all(math.isfinite(p) for frame in frames for p in frame.probabilities.values()):
        raise AssertionError(f"non-finite probabilities for {clip.name}")


def phase_fast_infer() -> dict:
    """``api.infer(profile="fast")`` on three clips cold and warm (handcrafted features on the card),
    the card's frame features held to the CPU route's, with a planted fault the limits must catch."""
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file
    from ser_tpu_torch.ops import dsp, features

    phase_started = time.perf_counter()
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        _write_head_envelope(root / "models" / "ser_model.pkl", feature_size=193, backend_id="handcrafted",
                             profile="fast", model_id=None)
        clips = []
        for index, seconds in enumerate((10.0, 45.0, 75.0)):
            clip = root / f"clip_{int(seconds)}s.wav"
            _write_clip(clip, seconds, 48000, seed=30 + index)
            clips.append((clip, seconds))
        settings = build_settings({"SER_MODELS_FOLDER": str(root / "models"), "SER_CACHE_DIR": str(root / "cache")})

        def run(clip: Path):
            started = time.perf_counter()
            execution = api.infer(clip, profile="fast", include_transcript=False, settings=settings)
            torch.cuda.synchronize()
            return execution, time.perf_counter() - started

        executions = [run(clip) for clip, _ in clips]
        warm = [run(clip)[1] for clip, _ in clips]
        breakdown = _profile(lambda: run(clips[1][0]), "fast-infer")
        audio, sample_rate = read_audio_file(str(clips[1][0]))

    def card_features():
        out, _, _ = features.extract_frame_features(audio, sample_rate, device="cuda")
        torch.cuda.synchronize()
        return out

    card = card_features()
    started = time.perf_counter()
    cpu, _, _ = features.extract_frame_features(audio, sample_rate, device="cpu")
    cpu_s = time.perf_counter() - started
    ratios = _fast_families(card, cpu)
    # Planted fault: the frame means taken over every column, the padded ones of a
    # truncated frame too (the column mask dropped).
    masked_mean = dsp.masked_mean_cols
    dsp.masked_mean_cols = lambda values, col_mask: values.mean(dim=-1)
    try:
        fault = _fast_families(card_features(), cpu)
    finally:
        dsp.masked_mean_cols = masked_mean
    # Informational: the projections in TF32 (the port keeps them float32).
    float32_products = dsp._float32_products
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    dsp._float32_products = lambda device: contextlib.nullcontext()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _fast_families(card_features(), cpu)
    finally:
        dsp._float32_products = float32_products
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32

    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        _check_fast_execution(execution, clip, seconds)
        say("fast-infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}",
            warm_latency_s=f"{warm_s:.4f}", frames=len(execution.detailed_result.frames),
            segments=len(execution.detailed_result.segments),
            labels=json.dumps(sorted({s.emotion for s in execution.detailed_result.segments})))
    say("fast-infer-profile", clip=clips[1][0].name, detail=breakdown)
    shown = lambda reading: json.dumps({family: f"{value:.3g}" for family, value in reading.items()})  # noqa: E731
    say("fast-infer-features", clip=clips[1][0].name, frames=card.shape[0], cpu_route_s=f"{cpu_s:.3f}",
        error_over_limit=shown(ratios), planted_unmasked_mean=shown(fault), tf32_products=shown(tf32))
    say("fast-infer-wall", seconds=f"{time.perf_counter() - phase_started:.1f}")
    if card.shape != cpu.shape or max(ratios.values()) > 1.0:
        raise AssertionError(f"the card's fast features disagree with the CPU route: {ratios}")
    if max(fault.values()) <= 1.0:
        raise AssertionError(f"the golden tolerances missed the planted fault: {fault}")
    return {"warm_latency_s": warm, "error_over_limit": ratios}


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


# --------------------------------------------------------------------------- #
# The rest of the transcript lane and the int8 lanes: beam, int8-decode, int8-encoder
# --------------------------------------------------------------------------- #


def _spans_around(spans: dict, patches: list[tuple[object, str]]) -> list[tuple[object, str, object]]:
    """Replaces each ``module.name`` by a wrapper that adds its synchronized host time to ``spans[name]``,
    a call that raises included; returns what to restore."""
    import torch

    restore = []
    for module, name in patches:
        original = getattr(module, name)

        def wrapper(*args, _fn=original, _name=name, **kwargs):
            torch.cuda.synchronize()
            started = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spans[_name] = spans.get(_name, 0.0) + time.perf_counter() - started

        setattr(module, name, wrapper)
        restore.append((module, name, original))
    return restore


def _restore(restore) -> None:
    for module, name, original in restore:
        setattr(module, name, original)


def _count_steps(counts: dict, module) -> object:
    """Counts calls of ``module._decoder_token_step`` (no synchronize); returns the original."""
    original = module._decoder_token_step

    def counting(*args, **kwargs):
        counts["steps"] = counts.get("steps", 0) + 1
        return original(*args, **kwargs)

    module._decoder_token_step = counting
    return original


def _transcription_model(**options):
    """Full-width large-v3 with the transcribe phase's seeded weights, bf16, no retries, 96-token budget."""
    import dataclasses

    import torch

    from ser_tpu_torch.models import whisper as wm

    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    model = wm.WhisperForTranscription(
        config,
        wm.random_whisper_encoder_state(config, seed=0, device=cuda),
        wm.random_whisper_decoder_state(config, seed=2, device=cuda),
        SyntheticTokenizer(),
        device=cuda,
        compute_dtype="bfloat16",
        **options,
    )
    # Random weights always look degenerate: retries would repeat the same work (bench.py:499-501).
    model.RETRY_TEMPERATURES = ()
    model.config = dataclasses.replace(config, max_target_positions=TRANSCRIPT_BUDGET)
    return model


def _clip_60s():
    import numpy as np

    return (0.2 * np.random.default_rng(0).standard_normal(int(60.0 * 16000))).astype(np.float32)


def _check_words(words, seconds: float) -> None:
    starts = [w.start_seconds for w in words]
    if not words or any(not (0.0 <= w.start_seconds < w.end_seconds <= seconds + 1e-6) for w in words):
        raise AssertionError(f"transcript words are missing or outside the clip: {words[:3]}")
    if starts != sorted(starts):
        raise AssertionError("transcript word starts are not in order")


def _run_transcript(model, audio, counters, spans, decode_module, *, cold: bool = True) -> dict:
    """A cold (unless ``cold`` is False) and a warm ``transcribe_words`` call: the launches of the
    first, the spans and steps of the warm one."""
    import torch

    def run():
        spans.clear()
        steps: dict = {}
        original = _count_steps(steps, decode_module)
        try:
            started = time.perf_counter()
            words = model.transcribe_words(audio, language="en", use_vad=False)
            torch.cuda.synchronize()
            return words, time.perf_counter() - started, steps.get("steps", 0)
        finally:
            decode_module._decoder_token_step = original

    for counter in counters:
        counter.launches = 0
    first = run()
    launches = {c.name: c.launches for c in counters}
    words, warm, steps = run() if cold else first
    return {"words": words, "cold": first[1] if cold else None, "warm": warm, "steps": steps, "launches": launches,
            "spans": dict(spans)}


def _beam_step_check(states_cpu, planted) -> tuple[float, float]:
    """2-layer full-width decoder, the beamed step (2 windows × 5 beams = 10 rows) in lockstep
    over 8 positions: bf16 on the card against float32 on the CPU, rel L2 of the logits, and
    the same with ``planted`` in place of the beamed cross-attention on the card. The CPU
    route picks each row's next token (the row's rank among the CPU's top 5), so the rows'
    histories differ."""
    import torch

    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models import whisper_decode as wd

    beams, steps = 5, 8
    config = wm.WhisperConfig(decoder_layers=2)
    state = wm.random_whisper_decoder_state(config, seed=5, device="cpu")
    state["pos_embed"] = torch.randn(state["pos_embed"].shape, generator=torch.Generator().manual_seed(6)) * 0.02
    card = wm.build_whisper_decoder(config, state, device=torch.device("cuda"), dtype=torch.bfloat16)
    routes = {
        "cpu": (wm.build_whisper_decoder(config, state, device=torch.device("cpu"), dtype=torch.float32),
                states_cpu, torch.float32, None),
        "card": (card, states_cpu.cuda(), torch.bfloat16, None),
        "planted": (card, states_cpu.cuda(), torch.bfloat16, planted),
    }
    rows = states_cpu.shape[0] * beams
    tokens = torch.full((rows, steps), EOT, dtype=torch.long)
    tokens[:, :3] = torch.tensor(PREFIX)
    logits = {}
    original = wd._attend_cross_step_beamed
    with torch.inference_mode():
        for name, (decoder, states, dtype, replacement) in routes.items():
            if replacement is not None:
                wd._attend_cross_step_beamed = replacement
            try:
                weights = wd.prepare_decode_weights(decoder, config, fused=False)
                cross = wd._precompute_cross_kv(decoder, states, 2, config.n_heads, dtype)
                head_dim, max_len = config.d_model // config.n_heads, config.max_target_positions
                caches = (
                    [torch.zeros((rows, config.n_heads, head_dim, max_len), dtype=dtype, device=states.device) for _ in range(2)],
                    [torch.zeros((rows, config.n_heads, max_len, head_dim), dtype=dtype, device=states.device) for _ in range(2)],
                )
                out = []
                for position in range(steps):
                    step_logits, _ = wd._decoder_token_step(
                        decoder, weights, *cross, *caches, tokens[:, position].to(states.device), position,
                        config=config, compute_dtype=dtype, beams=beams,
                    )
                    out.append(step_logits.float().cpu())
                    if name == "cpu" and position + 1 < steps and position + 1 >= 3:
                        ranked = torch.topk(step_logits, beams, dim=-1).indices
                        tokens[:, position + 1] = ranked[torch.arange(rows), torch.arange(rows) % beams]
            finally:
                wd._attend_cross_step_beamed = original
            logits[name] = torch.stack(out)
    return rel_l2(logits["card"], logits["cpu"]), rel_l2(logits["planted"], logits["cpu"])


def phase_beam() -> dict:
    """``transcribe_words(decode_strategy="beam", beam_size=5)`` on the 60 s clip at full width, and its checks."""
    import dataclasses

    import torch

    from ser_tpu_torch.models import attention, word_timing
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    model = _transcription_model(decode_strategy="beam", beam_size=5)
    torch.cuda.synchronize()
    say("beam-build", seconds=f"{time.perf_counter() - phase_started:.2f}")
    audio = _clip_60s()
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, *dsk.COUNTERS)
    spans: dict[str, float] = {}
    restore = _spans_around(spans, [
        (wm, "encode_mel_chunks"), (wd, "beam_decode_kv_cache"), (wd, "alignment_forward"),
        (wd, "reduce_alignment_matrix"), (word_timing, "word_timings_from_matrix"),
    ])
    try:
        run = _run_transcript(model, audio, counters, spans, wd)
    finally:
        _restore(restore)
    launches, words = run["launches"], run["words"]
    ms_per_step = run["spans"]["beam_decode_kv_cache"] / run["steps"] * 1e3
    say("beam", clip_seconds=60.0, windows=2, beam_size=5, rows=10, token_budget=TRANSCRIPT_BUDGET,
        cold_latency_s=f"{run['cold']:.4f}", warm_latency_s=f"{run['warm']:.4f}", words=len(words),
        beam_steps=run["steps"], ms_per_beam_step=f"{ms_per_step:.4f}",
        warm_spans_s=json.dumps({k: round(v, 4) for k, v in run["spans"].items()}), launches=json.dumps(launches))
    _check_words(words, 60.0)
    expected = {"stft_power_mel_log": 1, "power_mel_log": 0, "flash_attention_fwd": model.config.encoder_layers,
                **{c.name: 0 for c in dsk.COUNTERS}}
    if launches != expected:
        raise AssertionError(f"beam transcript launches {launches}, expected {expected}")

    # The same encoder states: beam-1 against the card's unfused greedy, and the
    # teacher-forced capture against the greedy loop's own.
    chunks = torch.from_numpy(audio.reshape(2, wm.CHUNK_SAMPLES)).cuda()
    states = wm.encode_mel_chunks(model.encoder, chunks)
    kwargs = dict(prefix_len=3, compute_dtype=torch.bfloat16, timestamp_begin=TIMESTAMP_BEGIN, weights=model.decode_weights())
    beam_tokens, beam_lengths = wd.beam_decode_kv_cache(model.decoder, model.config, states, PREFIX, EOT, beam_size=1, **kwargs)
    greedy_tokens, greedy_lengths, loop_align = wd.greedy_decode_kv_cache(
        model.decoder, model.config, states, PREFIX, EOT, fused=False, align_spec=model.alignment_heads, **kwargs
    )
    differ = (beam_tokens != greedy_tokens).any(dim=0).nonzero()
    say("beam-one", rows=2, lengths=beam_lengths.tolist(), greedy_lengths=greedy_lengths.tolist(),
        equal=bool(torch.equal(beam_tokens, greedy_tokens) and torch.equal(beam_lengths, greedy_lengths)),
        first_differing_position=int(differ[0].item()) if differ.numel() else None)
    if not (torch.equal(beam_tokens, greedy_tokens) and torch.equal(beam_lengths, greedy_lengths)):
        raise AssertionError("beam_size=1 differs from the unfused greedy decode")
    short = dataclasses.replace(model.config, max_target_positions=16)
    breakdown = _profile(lambda: wd.beam_decode_kv_cache(model.decoder, short, states, PREFIX, EOT, beam_size=5, **kwargs),
                         "beam")
    say("beam-profile", budget=16, detail=breakdown)
    forced = wd.alignment_forward(model.decoder, model.config, states, greedy_tokens, align_spec=model.alignment_heads,
                                  compute_dtype=torch.bfloat16)
    valid = [min(3 + int(n), TRANSCRIPT_BUDGET - 1) for n in greedy_lengths.tolist()]
    got = torch.cat([forced[b, :, : valid[b]].flatten() for b in range(2)])
    want = torch.cat([loop_align[b, :, : valid[b]].flatten() for b in range(2)])
    align_rel = rel_l2(got, want)
    say("beam-alignment", heads=len(model.alignment_heads), rows=valid, rel_l2=f"{align_rel:.5f}",
        max_abs=f"{(got - want).abs().max().item():.3g}", bound=ALIGN_CAPTURE_REL_L2_BOUND)
    if not align_rel <= ALIGN_CAPTURE_REL_L2_BOUND:
        raise AssertionError(f"alignment_forward's capture differs from the loop's: rel L2 {align_rel}")

    beamed = wd._attend_cross_step_beamed

    def planted(q, k_t, v_hs, *, beams, compute_dtype):  # every row attends window 0's states
        return beamed(q, k_t[:1].expand_as(k_t), v_hs[:1].expand_as(v_hs), beams=beams, compute_dtype=compute_dtype)

    # The second window's states negated: noise windows give rows nearly the same
    # cross-attention output, and a row that read the other window's K/V would not show.
    states_cpu = states.float().cpu() * torch.tensor([1.0, -1.0])[:, None, None]
    del model, states, forced, loop_align
    torch.cuda.empty_cache()
    step_rel, planted_rel = _beam_step_check(states_cpu, planted)
    say("beam-check", layers=2, rows=10, steps=8, logits_rel_l2=f"{step_rel:.5f}", bound=DECODE_CHECK_REL_L2_BOUND,
        planted_window_zero_cross_kv_rel_l2=f"{planted_rel:.5f}")
    if not step_rel <= DECODE_CHECK_REL_L2_BOUND:
        raise AssertionError(f"the card's beamed step disagrees with the CPU: rel L2 {step_rel}")
    if not planted_rel > DECODE_CHECK_REL_L2_BOUND:
        raise AssertionError(f"the planted cross-attention fault went unnoticed: rel L2 {planted_rel}")
    say("beam-phase", seconds=f"{time.perf_counter() - phase_started:.1f}")
    return {"launches": launches, "ms_per_beam_step": ms_per_step, "warm_latency_s": run["warm"]}


def _without_activation_scale(dense_int8):
    """A planted int8 fault: the per-token activation scale left out of the dequant (acc × wscale + bias)."""
    import torch

    from ser_tpu_torch.models import quant

    def planted(weight, x, dtype):
        _, ascale = quant.quantize_rows(x)
        bias = 0.0 if weight.bias is None else weight.bias.float()
        return ((dense_int8(weight, x, torch.float32) - bias) / ascale + bias).to(dtype)

    return planted


def _int8_step_correlation(model, states, *, positions: int = 8) -> float:
    """Lowest correlation, over rows and positions, of the W8A8 step's logits with the bf16
    unfused step's, both fed the bf16 route's greedy tokens."""
    import torch

    from ser_tpu_torch.models import whisper_decode as wd

    config, weights = model.config, model.decode_weights()
    n_layers, heads = config.decoder_layers, config.n_heads
    head_dim, rows = config.d_model // heads, states.shape[0]
    tokens = torch.full((rows, positions + 1), EOT, dtype=torch.long, device=states.device)
    tokens[:, :3] = torch.tensor(PREFIX, device=states.device)
    worst = 1.0
    with torch.inference_mode():
        cross = wd._precompute_cross_kv(model.decoder, states, n_layers, heads, torch.bfloat16)
        caches = {
            quantized: (
                [torch.zeros((rows, heads, head_dim, config.max_target_positions), dtype=torch.bfloat16,
                             device=states.device) for _ in range(n_layers)],
                [torch.zeros((rows, heads, config.max_target_positions, head_dim), dtype=torch.bfloat16,
                             device=states.device) for _ in range(n_layers)],
            )
            for quantized in (False, True)
        }
        for position in range(positions):
            logits = {}
            for quantized, (self_k, self_v) in caches.items():
                logits[quantized], _ = wd._decoder_token_step(
                    model.decoder, weights, *cross, self_k, self_v, tokens[:, position], position,
                    config=config, compute_dtype=torch.bfloat16, quant=weights.quant if quantized else None,
                )
            a = logits[False].double() - logits[False].double().mean(dim=-1, keepdim=True)
            b = logits[True].double() - logits[True].double().mean(dim=-1, keepdim=True)
            worst = min(worst, ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item())
            if position + 1 >= 3:
                tokens[:, position + 1] = torch.argmax(logits[False], dim=-1)
    return worst


def phase_int8_decode(decode: dict) -> dict:
    """The int8 decode weight stream (``SER_DECODE_INT8=1``) at full width: ``torch._int_mm`` against the
    CPU's exact product, the W8A8 step against the bf16 step, and ``transcribe_words`` on it."""
    import dataclasses

    import torch

    from ser_tpu_torch.models import attention, quant, word_timing
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models import whisper_decode as wd
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    config = wm.WhisperConfig()
    generator = torch.Generator().manual_seed(11)
    # The QKV projection (1280 → 3840) and the vocabulary projection (1280 → 51866, stored as 51872).
    for label, n in (("qkv", 3 * config.d_model), ("vocab", config.vocab_size)):
        kernel = torch.randn((config.d_model, n), generator=generator) * 0.02
        weight_cpu, weight_card = quant.Int8Weight(kernel, None), quant.Int8Weight(kernel.cuda(), None)
        if not (torch.equal(weight_card.w8.cpu(), weight_cpu.w8) and torch.equal(weight_card.scale.cpu(), weight_cpu.scale)):
            raise AssertionError(f"{label}: the card quantized the weights differently from the CPU")
        for rows in (2, 10):
            a8 = torch.randint(-127, 128, (rows, config.d_model), dtype=torch.int8, generator=generator)
            card = quant.int8_product(a8.cuda(), weight_card).cpu()
            exact = torch._int_mm(a8, weight_cpu.w8.contiguous())
            equal = bool(torch.equal(card, exact))
            say("int8-matmul", projection=label, rows=rows, k=config.d_model, n=n,
                n_stored=weight_card.padded.shape[1], equal=equal)
            if not equal:
                raise AssertionError(f"torch._int_mm on the card differs from the exact product ({label}, {rows} rows)")
    layouts = {}
    a8 = torch.randint(-127, 128, (32, config.d_model), dtype=torch.int8, generator=generator).cuda()
    for layout, b8 in (("column-major", weight_card.padded), ("row-major", weight_card.padded.contiguous())):
        try:
            layouts[layout] = bool(torch.equal(torch._int_mm(a8, b8), torch._int_mm(a8, weight_card.padded)))
        except RuntimeError as err:
            layouts[layout] = f"refused: {str(err).splitlines()[0][:80]}"
    try:
        torch._int_mm(a8[:2], weight_card.padded)
        unpadded = "accepted"
    except RuntimeError as err:
        unpadded = f"refused: {str(err).splitlines()[0][:80]}"
    say("int8-matmul-layouts", **{k.replace("-", "_"): v for k, v in layouts.items()}, unpadded_two_rows=json.dumps(unpadded))

    model = _transcription_model(decode_int8=True)
    weights = model.decode_weights()
    if weights.quant is None or weights.fused is not None:
        raise AssertionError("the int8 model did not prepare the int8 weight stream alone")
    audio = _clip_60s()
    states = wm.encode_mel_chunks(model.encoder, torch.from_numpy(audio.reshape(2, wm.CHUNK_SAMPLES)).cuda())
    correlation = _int8_step_correlation(model, states)
    wd.dense_int8 = _without_activation_scale(quant.dense_int8)
    try:
        planted = _int8_step_correlation(model, states)
    finally:
        wd.dense_int8 = quant.dense_int8
    say("int8-decode-check", layers=config.decoder_layers, rows=2, positions=8,
        min_logit_correlation=f"{correlation:.5f}", bound=INT8_LOGITS_CORRELATION_BOUND,
        planted_no_activation_scale_correlation=f"{planted:.5f}")
    if not correlation > INT8_LOGITS_CORRELATION_BOUND:
        raise AssertionError(f"int8 step logits correlate {correlation} with bf16, not above {INT8_LOGITS_CORRELATION_BOUND}")
    if not planted <= INT8_LOGITS_CORRELATION_BOUND:
        raise AssertionError(f"the planted int8 fault went unnoticed: correlation {planted}")
    short = dataclasses.replace(model.config, max_target_positions=16)
    breakdown = _profile(lambda: wd.greedy_decode_kv_cache(
        model.decoder, short, states, PREFIX, EOT, prefix_len=3, compute_dtype=torch.bfloat16,
        timestamp_begin=TIMESTAMP_BEGIN, quant_int8=True, weights=weights), "int8-decode")
    say("int8-decode-profile", budget=16, detail=breakdown)

    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, *dsk.COUNTERS)
    spans: dict[str, float] = {}
    restore = _spans_around(spans, [(wm, "encode_mel_chunks"), (wd, "greedy_decode_kv_cache"),
                                    (word_timing, "word_timings_from_matrix")])
    try:
        # The encode and the int8 decode have run above (the checks, the profile): one warm call.
        run = _run_transcript(model, audio, counters, spans, wd, cold=False)
    finally:
        _restore(restore)
    launches, words = run["launches"], run["words"]
    ms_per_step = run["spans"]["greedy_decode_kv_cache"] / run["steps"] * 1e3
    say("int8-decode", clip_seconds=60.0, windows=2, token_budget=TRANSCRIPT_BUDGET,
        warm_latency_s=f"{run['warm']:.4f}", words=len(words),
        steps=run["steps"], ms_per_step=f"{ms_per_step:.4f}",
        bf16_unfused_ms_per_step=f"{decode['unfused_ms_per_step']:.4f}",
        bf16_fused_ms_per_step=f"{decode['fused_ms_per_step']:.4f}",
        warm_spans_s=json.dumps({k: round(v, 4) for k, v in run["spans"].items()}), launches=json.dumps(launches))
    _check_words(words, 60.0)
    expected = {"stft_power_mel_log": 1, "power_mel_log": 0, "flash_attention_fwd": config.encoder_layers,
                **{c.name: 0 for c in dsk.COUNTERS}}
    if launches != expected:
        raise AssertionError(f"int8 transcript launches {launches}, expected {expected}")
    del model, weights, states
    torch.cuda.empty_cache()
    say("int8-decode-phase", seconds=f"{time.perf_counter() - phase_started:.1f}")
    return {"launches": launches, "ms_per_step": ms_per_step}


def _projection_ops(config, n_windows: int) -> float:
    """2·MACs of the encoder's W8A8 products (q, k, v, out and both MLP products) at 1500 states."""
    t, d = 1500, config.d_model
    return 2.0 * config.encoder_layers * (4 * t * d * d + 2 * t * d * 4 * d) * n_windows


def phase_int8_encoder() -> dict:
    """The int8 encoder (``SER_TORCH_DTYPE=int8``) at full width on 8 windows, its states against
    bf16's, and ``api.infer(profile="accurate")`` on three clips with it."""
    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch.models import attention, quant
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.ops import log_mel, resample

    phase_started = time.perf_counter()
    config = wm.WhisperConfig()
    cuda = torch.device("cuda")
    state = wm.random_whisper_encoder_state(config, seed=0, device=cuda)
    encoders = {
        "int8": wm.build_whisper_encoder(config, state, device=cuda, dtype=torch.bfloat16, quant_int8=True),
        "bf16": wm.build_whisper_encoder(config, state, device=cuda, dtype=torch.bfloat16),
    }
    del state
    n_windows, repeats = 8, 3
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy((0.1 * rng.standard_normal((n_windows, wm.CHUNK_SAMPLES))).astype(np.float32)).to(cuda)
    readings, states = {}, {}
    for label, encoder in encoders.items():
        states[label] = wm.encode_mel_chunks(encoder, chunks)  # warm-up
        for counter in (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER):
            counter.launches = 0
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(repeats):
            wm.encode_mel_chunks(encoder, chunks)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - started) / repeats
        readings[label] = {"ms_per_encode": elapsed * 1e3, "audio_s_per_s": n_windows * 30.0 / elapsed,
                           "k1_per_encode": log_mel.FUSED_COUNTER.launches / repeats,
                           "k1_spectrum_per_encode": log_mel.COUNTER.launches / repeats,
                           "k2_per_encode": attention.COUNTER.launches / repeats}
    tops = _projection_ops(config, n_windows) / (readings["int8"]["ms_per_encode"] / 1e3) / 1e12
    a, b = states["int8"].double().flatten(), states["bf16"].double().flatten()
    cosine = (a @ b / (a.norm() * b.norm())).item()
    dense_int8 = quant.dense_int8
    quant.dense_int8 = _without_activation_scale(dense_int8)
    try:
        planted = wm.encode_mel_chunks(encoders["int8"], chunks).double().flatten()
    finally:
        quant.dense_int8 = dense_int8
    planted_cosine = (planted @ b / (planted.norm() * b.norm())).item()
    say("int8-encoder", windows=n_windows, repeats=repeats,
        ms_per_encode=f"{readings['int8']['ms_per_encode']:.2f}", audio_s_per_s=f"{readings['int8']['audio_s_per_s']:.1f}",
        product_tops=f"{tops:.1f}", bf16_ms_per_encode=f"{readings['bf16']['ms_per_encode']:.2f}",
        cosine_to_bf16=f"{cosine:.6f}", bound=INT8_ENCODER_COSINE_BOUND,
        planted_no_activation_scale_cosine=f"{planted_cosine:.5f}",
        k1_per_encode=readings["int8"]["k1_per_encode"], k1_spectrum_form_per_encode=readings["int8"]["k1_spectrum_per_encode"],
        k2_per_encode=readings["int8"]["k2_per_encode"])
    if (readings["int8"]["k1_per_encode"], readings["int8"]["k1_spectrum_per_encode"], readings["int8"]["k2_per_encode"]) != (1, 0, config.encoder_layers):
        raise AssertionError(f"int8 encode launches {readings['int8']}, expected K1 1, spectrum form 0, K2 one a layer")
    if not cosine >= INT8_ENCODER_COSINE_BOUND:
        raise AssertionError(f"int8 encoder states: cosine {cosine} to bf16, below {INT8_ENCODER_COSINE_BOUND}")
    if not planted_cosine < INT8_ENCODER_COSINE_BOUND:
        raise AssertionError(f"the planted int8 fault went unnoticed: cosine {planted_cosine}")
    say("int8-encoder-profile", detail=_profile(lambda: wm.encode_mel_chunks(encoders["int8"], chunks), "int8-encoder"))
    del encoders, states, planted
    torch.cuda.empty_cache()

    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        artifact = root / "models" / profile_artifact_file_name(profile="accurate", model_id="openai/whisper-large-v3")
        _write_head_envelope(artifact, feature_size=2 * config.d_model)
        clips = []
        for index, seconds in enumerate((10.0, 45.0, 75.0)):
            clip = root / f"clip_{int(seconds)}s.wav"
            _write_clip(clip, seconds, 48000, seed=index)
            clips.append((clip, seconds))
        os.environ["SER_ALLOW_RANDOM_INIT"] = "1"
        os.environ["SER_RANDOM_INIT_SIZE"] = "full"
        settings = build_settings({
            "SER_ENABLE_ACCURATE_PROFILE": "1",
            "SER_MODELS_FOLDER": str(root / "models"),
            "SER_CACHE_DIR": str(root / "cache"),
            "SER_TORCH_DTYPE": "int8",
        })

        def run(clip: Path):
            started = time.perf_counter()
            execution = api.infer(clip, profile="accurate", include_transcript=False, settings=settings)
            torch.cuda.synchronize()
            return execution, time.perf_counter() - started

        counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, resample.COUNTER)
        for counter in counters:
            counter.launches = 0
        executions = [run(clip) for clip, _ in clips]
        launches = {c.name: c.launches for c in counters}
        warm = [run(clip)[1] for clip, _ in clips]
    for (execution, cold_s), warm_s, (clip, seconds) in zip(executions, warm, clips):
        _check_segments(execution, clip, seconds, "jax_whisper_encoder")
        say("int8-infer", clip=clip.name, seconds=seconds, cold_latency_s=f"{cold_s:.4f}", warm_latency_s=f"{warm_s:.4f}",
            segments=len(execution.detailed_result.segments))
    expected = {"stft_power_mel_log": len(clips), "power_mel_log": 0,
                "flash_attention_fwd": config.encoder_layers * len(clips), "resample_rows": len(clips)}
    say("int8-infer-launches", **launches)
    if launches != expected:
        raise AssertionError(f"int8 infer launches {launches}, expected {expected}")
    say("int8-encoder-phase", seconds=f"{time.perf_counter() - phase_started:.1f}")
    return {"encode": readings, "tops": tops, "cosine": cosine, "infer_launches": launches}


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

    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.BWD_COUNTER)
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
    expected = {"stft_power_mel_log": 1, "power_mel_log": 0, "flash_attention_fwd": 2 * config.encoder_layers,
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


# --------------------------------------------------------------------------- #
# K2 re-measured, the inference boundary, the fast head's trainer
# --------------------------------------------------------------------------- #


def sm_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature, as ``nvidia-smi`` reads them."""
    completed = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return completed.stdout.strip().splitlines()[0]


def phase_k2_remeasure() -> dict:
    """K2 and SDPA on the same (8, 1500, 20, 64) bf16 tensors, five readings each in turns."""
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.models import attention

    torch.manual_seed(1)
    q, k, v = (torch.randn(8, 1500, 20, 64, device="cuda").to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    clocks_before = sm_clocks()
    readings = interleaved_ms({
        "K2": lambda: attention.flash_attention(q, k, v),
        "SDPA": lambda: F.scaled_dot_product_attention(qt, kt, vt),
    })
    clocks_after = sm_clocks()
    ratio = readings["K2"]["ms"] / readings["SDPA"]["ms"]
    say("k2-remeasure", shape="(8,1500,20,64) bf16", runs=5, k2_ms=spread(readings["K2"]),
        sdpa_ms=spread(readings["SDPA"]), k2_over_sdpa=f"{ratio:.3f}", clocks_before=json.dumps(clocks_before),
        clocks_after=json.dumps(clocks_after))
    return {"k2": readings["K2"], "sdpa": readings["SDPA"], "k2_over_sdpa": ratio}


class _PlantedEncodes:
    """Wraps one encoder backend's ``encode_sequence``: counts the encodes, records their
    intervals on the host clock (each ends in a synchronize), and plants a fault on demand."""

    def __init__(self, backend) -> None:
        self.original = backend.encode_sequence
        self.mode: str | None = None
        self.calls = 0
        self.in_flight = 0
        self.intervals: list[tuple[float, float]] = []
        self._guard = threading.Lock()
        backend.encode_sequence = self

    def __call__(self, audio, sample_rate):
        import torch

        from ser_tpu_torch._internal.runtime.errors import TransientInferenceError

        with self._guard:
            self.calls += 1
            self.in_flight += 1
            first = self.calls == 1
        try:
            if self.mode == "oom":
                free, _total = torch.cuda.mem_get_info()
                torch.empty(free + (4 << 30), dtype=torch.uint8, device="cuda")  # more than is free
            started = time.perf_counter()
            encoded = self.original(audio, sample_rate)
            torch.cuda.synchronize()
            self.intervals.append((started, time.perf_counter()))
            if self.mode == "transient-once" and first:
                raise TransientInferenceError("planted transient card error", profile="accurate")
            return encoded
        finally:
            with self._guard:
                self.in_flight -= 1

    def start(self, mode: str | None) -> None:
        self.mode, self.calls, self.intervals = mode, 0, []

    def settle(self) -> None:
        """Waits for an abandoned (timed-out) attempt's encode to end."""
        import torch

        while self.in_flight:
            time.sleep(0.01)
        torch.cuda.synchronize()


def _segments_of(execution) -> list[tuple]:
    return [(s.emotion, round(s.start_seconds, 6), round(s.end_seconds, 6)) for s in execution.detailed_result.segments]


def _max_prob_diff(a, b) -> float:
    return max(abs(p - fb.probabilities[label]) for fa, fb in zip(a.detailed_result.frames, b.detailed_result.frames,
                                                                  strict=True)
               for label, p in fa.probabilities.items())


def phase_boundary() -> dict:
    """``api.infer(profile="accurate")`` (large-v3, seeded, bf16) on a 45 s clip through the retry
    ladder: plain; a transient error after the first encode; a real device OOM; a soft timeout;
    a spawned worker; two threads under the single flight."""
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.runtime.errors import InferenceTimeoutError, TransientInferenceError
    from ser_tpu_torch._internal.runtime.single_flight import GLOBAL_SINGLE_FLIGHT
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel

    gc.collect()
    torch.cuda.empty_cache()  # the spawned worker builds its own copy of the weights on the card
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER)
    per_encode = {"stft_power_mel_log": 1, "power_mel_log": 0, "flash_attention_fwd": 32}
    results: dict = {}
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_boundary_") as tmp:
        root = Path(tmp)
        _write_head_envelope(root / "models" / profile_artifact_file_name(
            profile="accurate", model_id="openai/whisper-large-v3"), feature_size=2 * 1280)
        clip, seconds = root / "clip_45s.wav", 45.0
        _write_clip(clip, seconds, 48000, seed=1)
        base = {"SER_ENABLE_ACCURATE_PROFILE": "1", "SER_MODELS_FOLDER": str(root / "models"),
                "SER_CACHE_DIR": str(root / "cache"), "SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"}
        os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
        settings = build_settings(base)
        planted = _PlantedEncodes(encoders.build_encoder_backend("accurate", settings))

        def request(case_settings, mode: str | None = None):
            planted.start(mode)
            for counter in counters:
                counter.launches = 0
            started = time.perf_counter()
            try:
                return api.infer(clip, profile="accurate", include_transcript=False, settings=case_settings), None, \
                    time.perf_counter() - started
            except Exception as err:  # noqa: BLE001 - each case names the error it expects
                return None, err, time.perf_counter() - started
            finally:
                planted.settle()

        def report(case: str, wall: float, attempts: int, **fields) -> None:
            launches = {c.name: c.launches for c in counters}
            results[case] = {"wall_s": wall, "attempts": attempts, "launches": launches, **fields}
            say("boundary", case=case, wall_s=f"{wall:.4f}", attempts=attempts, launches=json.dumps(launches),
                **{key: value for key, value in fields.items()})

        request(settings)  # warm: the backend and the head are loaded
        plain, error, wall = request(settings)
        if error is not None:
            raise error
        _check_segments(plain, clip, seconds, "jax_whisper_encoder")
        report("plain", wall, planted.calls, segments=len(plain.detailed_result.segments))
        if results["plain"]["launches"] != per_encode or planted.calls != 1:
            raise AssertionError(f"plain request: {results['plain']}")

        retried, error, wall = request(settings, "transient-once")
        if error is not None:
            raise error
        report("transient-once", wall, planted.calls, max_prob_diff=f"{_max_prob_diff(retried, plain):.3g}")
        if planted.calls != 2 or _segments_of(retried) != _segments_of(plain):
            raise AssertionError("the retry after a transient error did not give the plain request's segments")
        if results["transient-once"]["launches"] != {name: 2 * n for name, n in per_encode.items()}:
            raise AssertionError(f"K1/K2 did not launch for both attempts: {results['transient-once']['launches']}")

        _, error, wall = request(settings, "oom")
        report("hard-oom", wall, planted.calls, error=type(error).__name__,
               hard_oom=getattr(error, "hard_oom", None), message=json.dumps(str(error)[:120]))
        if not (isinstance(error, TransientInferenceError) and error.hard_oom and planted.calls == 2):
            raise AssertionError(f"a device OOM was not retried once and raised as a hard OOM: {error!r}")
        if not isinstance(error.__cause__, torch.cuda.OutOfMemoryError):
            raise AssertionError(f"the hard OOM's cause is not the card's OutOfMemoryError: {error.__cause__!r}")

        timeout_settings = build_settings({**base, "SER_ACCURATE_TIMEOUT_SECONDS": "0.005",
                                           "SER_ACCURATE_MAX_TIMEOUT_RETRIES": "0"})
        _, error, wall = request(timeout_settings)
        report("timeout", wall, planted.calls, error=type(error).__name__)
        if not isinstance(error, InferenceTimeoutError) or planted.calls != 1:
            raise AssertionError(f"a compute over its budget did not raise InferenceTimeoutError: {error!r}")

        isolated_env = {**base, "SER_ACCURATE_PROCESS_ISOLATION": "1"}
        saved = {name: os.environ.get(name) for name in isolated_env}
        os.environ.update(isolated_env)  # the spawned worker reads its settings from its environment
        try:
            isolated, error, wall = request(build_settings(isolated_env))
        finally:
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value
        if error is not None:
            raise error
        report("isolated", wall, 1, child_cold_wall_s=f"{wall:.2f}", parent_encodes=planted.calls,
               max_prob_diff=f"{_max_prob_diff(isolated, plain):.3g}")
        if planted.calls != 0 or _segments_of(isolated) != _segments_of(plain):
            raise AssertionError("the spawned worker's segments differ from the in-process request's")

        planted.start(None)
        outcomes: list = []
        threads = [threading.Thread(target=lambda: outcomes.append(
            api.infer(clip, profile="accurate", include_transcript=False, settings=settings))) for _ in range(2)]
        started = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        wall = time.perf_counter() - started
        spans = sorted(planted.intervals)
        overlap = any(later[0] < earlier[1] for earlier, later in zip(spans, spans[1:]))
        report("two-threads", wall, planted.calls, overlapping_encodes=overlap,
               encode_ms=json.dumps([round((end - start) * 1e3, 2) for start, end in spans]))
        if len(outcomes) != 2 or planted.calls != 2 or overlap or GLOBAL_SINGLE_FLIGHT.active_keys():
            raise AssertionError(f"the single flight did not serialize two threads: {results['two-threads']}")
        if any(_segments_of(outcome) != _segments_of(plain) for outcome in outcomes):
            raise AssertionError("a threaded request's segments differ from the plain request's")
    return results


def _write_fast_corpus(root: Path, *, actors: int, clips: int, seconds: float, sample_rate: int) -> list[Path]:
    """RAVDESS-named clips ``03-01-EE-01-01-RR-AA.wav`` under ``Actor_AA``: each class a tone
    (fundamental and two partials) and its own noise share, each clip its own seeded noise,
    pitch jitter and amplitude; two files with a corrupt header."""
    import numpy as np

    from ser_tpu_torch._internal.utils.audio_io import write_wav

    t = np.arange(int(seconds * sample_rate)) / sample_rate
    written = []
    for actor in range(1, actors + 1):
        folder = root / f"Actor_{actor:02d}"
        folder.mkdir(parents=True, exist_ok=True)
        for code in range(1, 9):
            for clip in range(1, clips + 1):
                written.append(folder / f"03-01-{code:02d}-01-01-{clip:02d}-{actor:02d}.wav")
                write_wav(written[-1], _fast_class_audio(code, t, seed=actor * 1000 + code * 100 + clip), sample_rate)
    for index in (1, 2):
        (root / "Actor_01" / f"03-01-0{index}-01-02-01-01.wav").write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunk")
    return written


def _fast_class_audio(code: int, t, *, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    f0 = 110.0 * 2 ** ((code - 1) * 5 / 12) * (1 + 0.01 * rng.standard_normal())
    tone = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)) / h for h in (1, 2, 3))
    noise_share = 0.05 + 0.04 * (code % 4)
    audio = (1 - noise_share) * tone / 1.8 + noise_share * rng.standard_normal(t.size)
    return (0.6 * rng.uniform(0.7, 1.0) * audio / np.abs(audio).max()).astype(np.float32)


def phase_fast_train() -> dict:
    """The fast profile trained on the card from a synthetic RAVDESS-named corpus and served:
    ``load_data`` (the 193 features on the card, held to the CPU route's), then
    ``api.train(profile="fast")``: its head's fit (held to the same fit on the CPU), its accuracy
    with a planted fault, the artifact through ``api.infer(profile="fast")``."""
    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.data import loader
    from ser_tpu_torch._internal.train.metrics import accuracy
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file, write_wav
    from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
    from ser_tpu_torch.ops import features

    actors, clips, seconds, sample_rate = 4, 6, 3.0, 48000
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_fast_train_") as tmp:
        root = Path(tmp)
        files = _write_fast_corpus(root / "dataset", actors=actors, clips=clips, seconds=seconds,
                                   sample_rate=sample_rate)
        env = {"SER_DATASET_FOLDER": str(root / "dataset"), "SER_MAX_FAILED_FILE_RATIO": "0.05",
               "SER_MODELS_FOLDER": str(root / "models"), "SER_CACHE_DIR": str(root / "cache")}
        settings = build_settings(env)

        started = time.perf_counter()
        x_train, x_test, y_train, y_test = loader.load_data(settings=settings)
        load_s = time.perf_counter() - started
        started = time.perf_counter()
        cpu_split = loader.load_data(settings=build_settings({**env, "SER_TORCH_DEVICE": "cpu"}))
        cpu_load_s = time.perf_counter() - started
        if (y_train, y_test) != (cpu_split[2], cpu_split[3]) or len(y_train) + len(y_test) != 8 * actors * clips:
            raise AssertionError("the card's and the CPU's loads differ in rows or labels")
        ratios = _fast_families(np.concatenate([x_train, x_test]), np.concatenate([cpu_split[0], cpu_split[1]]))
        decoded = [read_audio_file(str(path)) for path in files]
        features.extract_feature_vectors_batch(decoded[:8], device="cuda")
        torch.cuda.synchronize()
        started = time.perf_counter()
        features.extract_feature_vectors_batch(decoded, device="cuda")
        torch.cuda.synchronize()
        feature_s = time.perf_counter() - started
        say("fast-train-load", clips=len(y_train) + len(y_test), failed_files=2, train=len(y_train), test=len(y_test),
            load_data_s=f"{load_s:.3f}", cpu_load_data_s=f"{cpu_load_s:.3f}",
            features_audio_s_per_s=f"{len(decoded) * seconds / feature_s:.1f}", features_s=f"{feature_s:.4f}",
            error_over_limit=json.dumps({family: f"{value:.3g}" for family, value in ratios.items()}))
        if max(ratios.values()) > 1.0:
            raise AssertionError(f"the card's training features disagree with the CPU route: {ratios}")

        # The training path itself: api.train(profile="fast") (readiness and quarantine, the smoke, load_data,
        # the head's fit on the settings' device, the artifact), the split and the fit recorded on the way.
        seen: dict = {}
        load_data, fit = loader.load_data, TorchMLPClassifier.fit

        def recorded_load(*args, **kwargs):
            seen["split"] = load_data(*args, **kwargs)
            return seen["split"]

        def timed_fit(head, X, y):
            torch.cuda.synchronize()
            started = time.perf_counter()
            out = fit(head, X, y)
            torch.cuda.synchronize()
            seen["fit_s"], seen["head"] = time.perf_counter() - started, head
            return out

        loader.load_data, TorchMLPClassifier.fit = recorded_load, timed_fit
        started = time.perf_counter()
        try:
            api.train(profile="fast", settings=settings)
            torch.cuda.synchronize()
        finally:
            loader.load_data, TorchMLPClassifier.fit = load_data, fit
        train_s = time.perf_counter() - started
        report = json.loads(settings.models.training_report_file.read_text(encoding="utf-8"))
        x_train, x_test, y_train, y_test = seen["split"]
        head, fit_s = seen["head"], seen["fit_s"]
        if head.device.type != "cuda":
            raise AssertionError(f"api.train fitted the head on {head.device}, not on the card")
        cpu_head = TorchMLPClassifier.from_config(settings.nn, device="cpu").fit(x_train, y_train)
        if head.n_iter_ != cpu_head.n_iter_:
            raise AssertionError(f"the card's fit ran {head.n_iter_} epochs, the CPU's {cpu_head.n_iter_}")
        curve_err = float(np.max(np.abs(np.array(head.loss_curve_) - np.array(cpu_head.loss_curve_))
                                 / np.abs(np.array(cpu_head.loss_curve_))))
        predictions = head.predict(x_test)
        test_accuracy = accuracy(y_test, list(predictions))
        same_predictions = bool(np.array_equal(predictions, cpu_head.predict(x_test)))
        shuffled = list(np.random.default_rng(0).permutation(np.asarray(y_train)))
        fault_accuracy = accuracy(y_test, list(TorchMLPClassifier.from_config(settings.nn)
                                               .fit(x_train, shuffled).predict(x_test)))
        say("fast-train-fit", width="193-300-8", batch=settings.nn.batch_size, max_iter=settings.nn.max_iter,
            train_s=f"{train_s:.3f}", report_accuracy=f"{report['accuracy']:.4f}",
            epochs=head.n_iter_, cpu_epochs=cpu_head.n_iter_, ms_per_epoch=f"{fit_s / head.n_iter_ * 1e3:.3f}",
            fit_s=f"{fit_s:.3f}", loss=f"{head.loss_:.6f}", cpu_loss=f"{cpu_head.loss_:.6f}",
            loss_curve_max_rel_err=f"{curve_err:.3g}",
            loss_rtol=1e-4, same_test_predictions=same_predictions, test_accuracy=f"{test_accuracy:.4f}",
            planted_shuffled_labels_accuracy=f"{fault_accuracy:.4f}",
            quarantined=len(_quarantined_by_readiness(settings, "fast")))
        if not curve_err <= 1e-4 or not same_predictions:
            raise AssertionError("the card's fit departs from the CPU's on the same layers and permutations")
        if not test_accuracy >= 0.9 or not fault_accuracy < 0.5 or report["accuracy"] != test_accuracy:
            raise AssertionError(f"test accuracy {test_accuracy} (report {report['accuracy']}), "
                                 f"with shuffled labels {fault_accuracy}")

        held_out, code = root / "held_out.wav", 5
        write_wav(held_out, _fast_class_audio(code, np.arange(int(seconds * sample_rate)) / sample_rate, seed=99),
                  sample_rate)
        started = time.perf_counter()
        execution = api.infer(held_out, profile="fast", include_transcript=False, settings=settings)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - started
    expected = settings.emotions[f"{code:02d}"]
    frames = execution.detailed_result.frames
    say("fast-train-infer", clip="held_out_3s", latency_s=f"{infer_s:.4f}", frames=len(frames),
        first_frame=frames[0].emotion, expected=expected, backend=execution.backend_id)
    _check_fast_execution(execution, held_out, seconds)
    if frames[0].emotion != expected:
        raise AssertionError(f"the trained head labels a held-out {expected!r} clip {frames[0].emotion!r}")
    return {"epochs": head.n_iter_, "ms_per_epoch": fit_s / head.n_iter_ * 1e3, "test_accuracy": test_accuracy,
            "train_s": train_s}


# The host work of an encoder profile's training outside readiness, the smoke, the encode and the fit, each
# timed by _TrainProbe: (owner, name). Training's reads are timed apart, those that fail (the reader's retry
# sleeps on a corrupt file) apart from those that succeed.
_TRAIN_HOST_SPANS = (
    ("training_orchestration", "bounded_retry_local_io"), ("EmbeddingCache", "load"), ("EmbeddingCache", "store"), ("encoder_training", "temporal_pooling_windows"),
    ("encoder_training", "mean_std_pool"), ("encoder_training", "apply_noise_controls"),
    ("encoder_training", "_split_training_files"), ("artifacts", "save_model_artifact"),
)


class _TrainProbe:
    """Instruments one ``api.train`` run: readiness and smoke time, the encoder's calls in and out of
    the smoke, the rows ``_windowed_dataset`` returns, the head's fit and the host work of
    ``_TRAIN_HOST_SPANS``. ``arm`` runs once, when the smoke has returned (a planted fault that must
    reach the training encode, not the smoke)."""

    def __init__(self, backend, encode_attr: str, *, arm=None) -> None:
        import torch

        from ser_tpu_torch._internal.data.embedding_cache import EmbeddingCache
        from ser_tpu_torch._internal.models import (
            artifacts,
            encoder_training,
            training_orchestration,
            training_readiness,
        )
        from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

        owners = {"training_orchestration": training_orchestration, "encoder_training": encoder_training,
                  "EmbeddingCache": EmbeddingCache, "artifacts": artifacts}
        self.spans: dict[str, float] = {}
        self.host_spans: dict[str, float] = {}
        host_restore = _spans_around(self.host_spans, [(owners[owner], name) for owner, name in _TRAIN_HOST_SPANS])
        self.encodes = {"smoke": [], "train": []}  # (seconds, dtype) of each call
        self.rows: list[tuple] = []
        self.fits: list[dict] = []
        self.in_smoke = False
        probe = self
        self._restore = host_restore + _spans_around(self.spans, [(training_orchestration, "run_training_readiness")])
        smoke, windowed, fit, read = (training_readiness.run_backend_smoke, encoder_training._windowed_dataset,
                                      TorchMLPClassifier.fit, encoder_training.read_audio_file)
        encode = getattr(backend, encode_attr)

        def timed_read(*args, **kwargs):
            started, outcome = time.perf_counter(), "read_failed"
            try:
                out = read(*args, **kwargs)
                outcome = "read"
                return out
            finally:
                probe.host_spans[outcome] = probe.host_spans.get(outcome, 0.0) + time.perf_counter() - started

        def timed_smoke(*args, **kwargs):
            probe.in_smoke = True
            torch.cuda.synchronize()
            started = time.perf_counter()
            try:
                return smoke(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                probe.spans["smoke"] = time.perf_counter() - started
                probe.in_smoke = False
                if arm is not None:
                    arm()

        def timed_encode(*args, **kwargs):
            torch.cuda.synchronize()
            started = time.perf_counter()
            out = encode(*args, **kwargs)
            torch.cuda.synchronize()
            dtype = str(getattr(backend, "dtype", "bf16"))
            probe.encodes["smoke" if probe.in_smoke else "train"].append((time.perf_counter() - started, dtype))
            return out

        def recorded_windows(**kwargs):
            out = windowed(**kwargs)
            probe.rows.append(out)
            return out

        def timed_fit(head, X, y):
            torch.cuda.synchronize()
            started = time.perf_counter()
            out = fit(head, X, y)
            torch.cuda.synchronize()
            probe.fits.append({"seconds": time.perf_counter() - started, "epochs": head.n_iter_,
                               "device": str(head.device)})
            return out

        training_readiness.run_backend_smoke = timed_smoke
        encoder_training.read_audio_file = timed_read
        encoder_training._windowed_dataset = recorded_windows
        TorchMLPClassifier.fit = timed_fit
        # An instance attribute (a planted wrapper) comes back on close; else the class's method.
        self._backend_restore = (backend, encode_attr, backend.__dict__.get(encode_attr))
        setattr(backend, encode_attr, timed_encode)
        self._restore += [(training_readiness, "run_backend_smoke", smoke),
                          (encoder_training, "_windowed_dataset", windowed), (TorchMLPClassifier, "fit", fit),
                          (encoder_training, "read_audio_file", read)]

    def close(self) -> None:
        _restore(self._restore)
        backend, name, previous = self._backend_restore
        if previous is None:
            delattr(backend, name)
        else:
            setattr(backend, name, previous)

    def smoke_probes(self) -> int:
        return len(self.encodes["smoke"])


def _train_run(profile: str, settings, probe_factory, counters) -> tuple[dict, "_TrainProbe", dict, float]:
    """One ``api.train(profile=...)`` under a fresh probe, its kernels' counts set to 0 just before;
    returns the run's report (read back from disk), the probe, the counts and the wall seconds."""
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_names

    probe = probe_factory()
    for counter in counters:
        counter.launches = 0
    started = time.perf_counter()
    try:
        api.train(profile=profile, settings=settings)
        torch.cuda.synchronize()
    finally:
        probe.close()
    wall = time.perf_counter() - started
    launches = {counter.name: counter.launches for counter in counters}
    report_name = profile_artifact_file_names(profile=profile, model_id=settings.profile_model_id(profile))[2]
    report = json.loads((settings.models.folder / report_name).read_text(encoding="utf-8"))
    return report, probe, launches, wall


def _train_numbers(label: str, report: dict, probe: "_TrainProbe", launches: dict, wall: float,
                   seconds_per_clip: float) -> dict:
    """Prints one training run's numbers and returns them."""
    train_encodes = probe.encodes["train"]
    encode_s = sum(seconds for seconds, _ in train_encodes)
    # The split holds every labelled file; the two corrupt ones are quarantined when training reads them
    # (as in the JAX package), and every clip read is probed in the embedding cache before its encode.
    encoded = report["cache_probes"]["misses"]
    fit = probe.fits[0]
    # The wall seconds by cause: each span is synchronized and none holds another but the reads.
    host = {name: probe.host_spans.get(name, 0.0)
            for name in ("read", "read_failed", *(name for _, name in _TRAIN_HOST_SPANS))}
    parts = {
        "readiness": probe.spans["run_training_readiness"], "smoke": probe.spans["smoke"], "encode": encode_s,
        "read": host["read"], "read_failed": host["read_failed"],
        "read_retry_wrapper": host["bounded_retry_local_io"] - host["read"] - host["read_failed"],
        "cache_load": host["load"], "cache_store": host["store"],
        "pooling": host["temporal_pooling_windows"] + host["mean_std_pool"],
        "noise_controls": host["apply_noise_controls"], "split": host["_split_training_files"],
        "fit": fit["seconds"], "artifact_save": host["save_model_artifact"],
    }
    parts["other"] = wall - sum(parts.values())
    numbers = {
        "wall_s": wall, "readiness_s": probe.spans["run_training_readiness"], "smoke_s": probe.spans["smoke"],
        "smoke_probes": probe.smoke_probes(), "train_encode_calls": len(train_encodes),
        "clips_in_split": report["train_samples"] + report["test_samples"],
        "quarantined_mid_training": len(report.get("quarantined_mid_training", [])), "clips_encoded": encoded,
        "encode_s": encode_s, "encode_audio_s_per_s": encoded * seconds_per_clip / encode_s if encode_s else None,
        "train_windows": report["training_windows"], "test_windows": report["test_windows"],
        "epochs": fit["epochs"], "ms_per_epoch": fit["seconds"] / fit["epochs"] * 1e3, "fit_device": fit["device"],
        "window_uar": report["uar"], "grouped_uar": report["grouped"]["uar"], "test_accuracy": report["accuracy"],
        "cache_probes": report.get("cache_probes"), "launches": launches,
        "wall_parts_s": {name: round(seconds, 4) for name, seconds in parts.items()},
    }
    say(label, **{key: (f"{value:.4f}" if isinstance(value, float) else
                        json.dumps(value) if isinstance(value, dict) else value) for key, value in numbers.items()})
    return numbers


def _shuffled_label_accuracy(settings, probe: "_TrainProbe") -> float:
    """The planted fault: the run's own rows fitted with shuffled labels, scored on its test rows."""
    import numpy as np

    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
    from ser_tpu_torch._internal.train.metrics import accuracy
    from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

    (x_train, y_train, _, _), (x_test, y_test, _, _) = probe.rows[:2]
    shuffled = list(np.random.default_rng(0).permutation(np.asarray(y_train)))
    head = TorchMLPClassifier.from_config(settings.nn, device=resolve_device(settings.torch_runtime.device))
    return accuracy(y_test, list(head.fit(x_train, shuffled).predict(x_test)))


def _quarantined_by_readiness(settings, profile: str) -> list[str]:
    from ser_tpu_torch._internal.models.training_readiness import default_readiness_report_path

    return json.loads(default_readiness_report_path(settings, profile).read_text(encoding="utf-8"))["quarantined_files"]


def _same_rows(first: "_TrainProbe", second: "_TrainProbe") -> bool:
    import numpy as np

    return all(
        np.array_equal(a[0], b[0]) and a[1:3] == b[1:3] for a, b in zip(first.rows[:2], second.rows[:2])
    ) and len(first.rows) == len(second.rows) == 2


def _training_corpus(root: Path) -> list[Path]:
    """The encoder profiles' training corpus: 8 emotions × 4 actors × 3 clips of 3 s at 48 kHz, two corrupt."""
    return _write_fast_corpus(root, actors=4, clips=3, seconds=3.0, sample_rate=48000)


def _training_env(root: Path, tmp: str) -> dict:
    # Two corrupt files of 98: 2 % of the corpus, 1 of 13 of each of two classes, inside these budgets.
    return {"SER_DATASET_FOLDER": str(root / "dataset"), "SER_MODELS_FOLDER": str(root / "models"),
            "SER_CACHE_DIR": str(root / "cache"), "SER_TMP_FOLDER": str(root / tmp),
            "SER_MAX_FAILED_FILE_RATIO": "0.05", "SER_MAX_FAILED_FILE_RATIO_PER_CLASS": "0.1"}


def _plain_k1_k2(whisper_model, log_mel, attention):
    """Patches the Whisper encoder's K1 and K2 to their plain versions on the card (float32 attention); returns
    what to restore."""
    def plain_log_mel_raw(waveform, *, sr=16000, n_fft=400, hop_length=160, n_mels=128, n_frames_out=None):
        fb = log_mel._constant_on(waveform.device, log_mel._mel_fb_t, sr, n_fft, n_mels)
        return log_mel.stft_power_mel_log_reference(waveform.float().contiguous(), fb, n_frames_out)

    def plain_attention(q, k, v, *, frame_mask=None, compute_dtype=None):
        return attention.attention_reference(q.float(), k.float(), v.float(), frame_mask=frame_mask).to(q.dtype)

    restore = [(whisper_model, "log_mel_raw", whisper_model.log_mel_raw),
               (whisper_model, "multi_head_attention", whisper_model.multi_head_attention)]
    whisper_model.log_mel_raw = plain_log_mel_raw
    whisper_model.multi_head_attention = plain_attention
    return restore


def _masked_rows_check(label: str, backend, settings, profile: str, files: list[Path], counters) -> dict:
    """One 4 s-bucket batch of 32 training clips, encoded as training encodes them (``encode_clips``) and
    pooled as its rows are: through the backend's kernel (K2 in bf16, K2-f32 once the backend is float32),
    then with the plain attention patched into the encoder on the card, then with a planted leak of the
    padded frames into the keys; in float32 also with operands rounded to TF32. Each planted fault must land
    above the bound."""
    import numpy as np
    import torch

    from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
    from ser_tpu_torch._internal.repr.encode_util import encode_clips
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file
    from ser_tpu_torch.models import attention, wav2vec2

    runtime = settings.profile_runtime(profile)
    clips = [read_audio_file(str(path)) for path in files[:TRAIN_ENCODE_BATCH]]

    def plain(q, k, v, *, frame_mask=None, compute_dtype=None):
        return attention.attention_reference(q.float(), k.float(), v.float(), frame_mask=frame_mask).to(q.dtype)

    def leaky(q, k, v, *, frame_mask=None, compute_dtype=None):
        return plain(q, k, v)

    def tf32(q, k, v, *, frame_mask=None, compute_dtype=None):
        return _tf32_attention(q.float(), k.float(), v.float(), frame_mask).to(q.dtype)

    def pooled_rows(route=None) -> tuple[np.ndarray, dict]:
        for counter in counters:
            counter.launches = 0
        restore = [(wav2vec2, "multi_head_attention", wav2vec2.multi_head_attention)]
        if route is not None:
            wav2vec2.multi_head_attention = route
        try:
            encoded = encode_clips(backend, clips)
            torch.cuda.synchronize()
        finally:
            _restore(restore)
        rows = [mean_std_pool(item, temporal_pooling_windows(
            item, window_size_seconds=runtime.pool_window_size_seconds,
            window_stride_seconds=runtime.pool_window_stride_seconds)) for item in encoded]
        return np.concatenate(rows), {counter.name: counter.launches for counter in counters}

    def err(rows: np.ndarray, reference: np.ndarray) -> float:
        return float(np.linalg.norm(rows - reference) / np.linalg.norm(reference))

    dtype = backend.dtype
    bound, kernel = ((ENCODER_REL_L2_BOUND, attention.COUNTER.name) if dtype == torch.bfloat16
                     else (TRAIN_F32_ROW_REL_L2_BOUND, attention.F32_COUNTER.name))
    kernel_rows, kernel_launches = pooled_rows()
    plain_rows, plain_launches = pooled_rows(plain)
    line = {"dtype": str(dtype), "rows": kernel_rows.shape[0], "width": kernel_rows.shape[1],
            "rel_l2_err": err(kernel_rows, plain_rows), "bound": bound,
            "mask_leak_fault": err(pooled_rows(leaky)[0], plain_rows), "kernel_launches": kernel_launches,
            "plain_launches": sum(plain_launches.values())}
    if dtype == torch.float32:
        line["tf32_operands"] = err(pooled_rows(tf32)[0], plain_rows)
    say(label, **{key: (f"{value:.3g}" if isinstance(value, float) else
                        json.dumps(value) if isinstance(value, dict) else value) for key, value in line.items()})
    expected = {counter.name: 0 for counter in counters} | {kernel: backend._config.num_hidden_layers}
    faults = [line["mask_leak_fault"], line.get("tf32_operands", math.inf)]
    if (not line["rel_l2_err"] <= bound or line["plain_launches"] or kernel_launches != expected
            or not min(faults) > bound or backend.dtype != dtype):
        raise AssertionError(f"{label}: the training rows through the kernel against the plain version: {line}")
    return line


def _serve_held_out(root: Path, profile: str, settings, backend, report: dict) -> list[str]:
    """A held-out clip of the planted class 5 through ``api.infer``; its frames must be the trained head's own
    labels for the clip's pooled windows. Returns the served labels."""
    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.models import artifacts
    from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file, write_wav

    held_out, code, seconds, sample_rate = root / "held_out.wav", 5, 3.0, 48000
    write_wav(held_out, _fast_class_audio(code, np.arange(int(seconds * sample_rate)) / sample_rate, seed=99),
              sample_rate)
    started = time.perf_counter()
    execution = api.infer(held_out, profile=profile, include_transcript=False, settings=settings)
    torch.cuda.synchronize()
    latency = time.perf_counter() - started
    encoded = backend.encode_sequence(*read_audio_file(str(held_out)))
    runtime = settings.profile_runtime(profile)
    windows = temporal_pooling_windows(encoded, window_size_seconds=runtime.pool_window_size_seconds,
                                       window_stride_seconds=runtime.pool_window_stride_seconds)
    head = artifacts.load_model_artifact(report["model_path"], expected_profile=profile,
                                         device=resolve_device(settings.torch_runtime.device)).model
    own_labels = [str(label) for label in head.predict(mean_std_pool(encoded, windows))]
    frames = [frame.emotion for frame in execution.detailed_result.frames]
    _check_segments(execution, held_out, seconds, report["backend_id"])
    say(f"{profile}-train-infer", clip="held_out_3s", latency_s=f"{latency:.4f}", frames=len(frames),
        first_frame=frames[0], planted=settings.emotions[f"{code:02d}"], head_labels=json.dumps(own_labels))
    if frames != own_labels:
        raise AssertionError(f"api.infer served {frames}, the trained {profile} head says {own_labels}")
    return frames


def phase_accurate_train() -> dict:
    """``api.train(profile="accurate")`` at large-v3 width (seeded random weights, bf16) on a synthetic
    RAVDESS-named corpus: readiness and quarantine, the smoke, the encode through K1 and K2, the head's
    fit on the card; a planted shuffled-label fault; a second run from the embedding cache; the pooled
    rows of two clips against K1 and K2 patched to their plain versions; the artifact served by
    ``api.infer``."""
    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file, write_wav
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import whisper as whisper_model
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    seconds, sample_rate = 3.0, 48000
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER)
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_accurate_train_") as tmp:
        root = Path(tmp)
        files = _training_corpus(root / "dataset")
        settings = build_settings({**_training_env(root, "tmp"), "SER_ENABLE_ACCURATE_PROFILE": "1"})
        started = time.perf_counter()
        backend = encoders.build_encoder_backend("accurate", settings)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - started
        say("accurate-train-backend", build_s=f"{build_s:.3f}", d_model=backend.feature_dim,
            layers=backend._config.encoder_layers)

        report, first, launches, wall = _train_run(
            "accurate", settings, lambda: _TrainProbe(backend, "encode_sequence"), counters)
        numbers = _train_numbers("accurate-train", report, first, launches, wall, seconds)
        fault = _shuffled_label_accuracy(settings, first)
        layers = backend._config.encoder_layers
        windows = numbers["smoke_probes"] + numbers["train_encode_calls"]  # one 30 s window a 3 s clip
        quarantined = _quarantined_by_readiness(settings, "accurate")
        say("accurate-train-check", windows_encoded=windows, k1_expected=windows, k2_expected=layers * windows,
            test_accuracy=f"{report['accuracy']:.4f}", bar=ACCURATE_TRAIN_ACCURACY_BAR,
            planted_shuffled_labels_accuracy=f"{fault:.4f}", quarantined=len(quarantined),
            split=report["split_metadata"]["split_strategy"])
        if len(quarantined) != 2:
            raise AssertionError(f"readiness quarantined {quarantined}, expected the two corrupt files")
        expected = {"stft_power_mel_log": windows, "power_mel_log": 0, "flash_attention_fwd": layers * windows,
                    "flash_attention_f32": 0}
        if launches != expected or numbers["train_encode_calls"] != numbers["clips_encoded"]:
            raise AssertionError(f"accurate training launched {launches}, expected {expected}")
        if (numbers["smoke_probes"] != 16 or numbers["clips_encoded"] != 96 or numbers["quarantined_mid_training"] != 2
                or not numbers["fit_device"].startswith("cuda")):
            raise AssertionError(f"smoke probes {numbers['smoke_probes']}, clips encoded {numbers['clips_encoded']}, "
                                 f"quarantined {numbers['quarantined_mid_training']}, fit on {numbers['fit_device']}")
        if not report["accuracy"] >= ACCURATE_TRAIN_ACCURACY_BAR or not fault < 0.5:
            raise AssertionError(f"test accuracy {report['accuracy']}, with shuffled labels {fault}")

        # The same corpus again: every clip from the embedding cache, only the smoke encodes.
        cached, second, cached_launches, cached_wall = _train_run(
            "accurate", settings, lambda: _TrainProbe(backend, "encode_sequence"), counters)
        cached_numbers = _train_numbers("accurate-train-cached", cached, second, cached_launches, cached_wall,
                                        seconds)
        probes = second.smoke_probes()
        same_rows = _same_rows(first, second)
        same_metrics = all(cached[key] == report[key] for key in ("accuracy", "uar", "macro_f1", "grouped"))
        say("accurate-train-cache", hits=json.dumps(cached["cache_probes"]), same_rows_bit_for_bit=same_rows,
            same_metrics=same_metrics, k1=cached_launches["stft_power_mel_log"], smoke_probes=probes)
        if (cached["cache_probes"] != {"hits": 96, "misses": 0} or second.encodes["train"] or not same_rows
                or not same_metrics or cached_launches["stft_power_mel_log"] != probes
                or cached_launches["flash_attention_fwd"] != layers * probes):
            raise AssertionError(f"the cached run: {cached['cache_probes']}, launches {cached_launches}, "
                                 f"rows {same_rows}, metrics {same_metrics}")

        # Two clips' pooled rows with K1 and K2 against both patched to their plain versions.
        runtime = settings.accurate_runtime

        def pooled_rows() -> np.ndarray:
            rows = []
            for path in files[:2]:
                encoded = backend.encode_sequence(*read_audio_file(str(path)))
                windows_ = temporal_pooling_windows(encoded, window_size_seconds=runtime.pool_window_size_seconds,
                                                    window_stride_seconds=runtime.pool_window_stride_seconds)
                rows.append(mean_std_pool(encoded, windows_))
            return np.concatenate(rows)

        kernel_rows = pooled_rows()
        for counter in counters:
            counter.launches = 0
        restore = _plain_k1_k2(whisper_model, log_mel, attention)
        try:
            plain_rows = pooled_rows()
        finally:
            _restore(restore)
        plain_launches = sum(counter.launches for counter in counters)
        row_err = float(np.linalg.norm(kernel_rows - plain_rows) / np.linalg.norm(plain_rows))
        say("accurate-train-kernels", rows=kernel_rows.shape[0], width=kernel_rows.shape[1],
            rel_l2_err=f"{row_err:.3g}", bound=ENCODER_REL_L2_BOUND, plain_launches=plain_launches)
        if not row_err <= ENCODER_REL_L2_BOUND or plain_launches:
            raise AssertionError(f"K1/K2 rows against the plain versions: rel L2 {row_err}, {plain_launches} launches")

        held_out, code = root / "held_out.wav", 5
        write_wav(held_out, _fast_class_audio(code, np.arange(int(seconds * sample_rate)) / sample_rate, seed=99),
                  sample_rate)
        started = time.perf_counter()
        execution = api.infer(held_out, profile="accurate", include_transcript=False, settings=settings)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - started
    expected_label = settings.emotions[f"{code:02d}"]
    frames = execution.detailed_result.frames
    _check_segments(execution, held_out, seconds, "jax_whisper_encoder")
    say("accurate-train-infer", clip="held_out_3s", latency_s=f"{infer_s:.4f}", frames=len(frames),
        first_frame=frames[0].emotion, expected=expected_label)
    if frames[0].emotion != expected_label:
        raise AssertionError(f"the trained head labels a held-out {expected_label!r} clip {frames[0].emotion!r}")
    wall_s = time.perf_counter() - phase_started
    say("accurate-train-wall", wall_s=f"{wall_s:.1f}")
    return {"numbers": numbers, "cached": cached_numbers, "launches": launches, "row_rel_l2_err": row_err,
            "shuffled_accuracy": fault, "wall_s": wall_s}


def phase_medium_train() -> dict:
    """``api.train(profile="medium")`` at XLS-R 300M width (seeded random weights, bf16) on the same corpus:
    the cross-clip masked encode through K2, the head's fit on the card, a planted shuffled-label fault, a
    cached rerun, the training rows through masked K2 against the plain attention, the artifact served by
    ``api.infer``; then a run whose first training encode a planted wrapper makes non-finite: the retry runs
    in float32 through K2-f32, the backend stays float32, and its rows through K2-f32 are held against the
    float32 plain attention."""
    import torch

    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    counters = (attention.COUNTER, attention.F32_COUNTER, log_mel.FUSED_COUNTER)
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_medium_train_") as tmp:
        root = Path(tmp)
        files = _training_corpus(root / "dataset")
        settings = build_settings({**_training_env(root, "tmp"), "SER_ENABLE_MEDIUM_PROFILE": "1"})
        backend = encoders.build_encoder_backend("medium", settings)
        layers = backend._config.num_hidden_layers
        report, first, launches, wall = _train_run(
            "medium", settings, lambda: _TrainProbe(backend, "_encode_batch"), counters)
        numbers = _train_numbers("medium-train", report, first, launches, wall, 3.0)
        fault = _shuffled_label_accuracy(settings, first)
        calls = numbers["smoke_probes"] + numbers["train_encode_calls"]
        expected = {"flash_attention_fwd": layers * calls, "flash_attention_f32": 0, "stft_power_mel_log": 0}
        quarantined = _quarantined_by_readiness(settings, "medium")
        say("medium-train-check", encode_calls=calls, smoke_calls=numbers["smoke_probes"],
            train_calls=numbers["train_encode_calls"], masked_k2_expected=layers * calls,
            test_accuracy=f"{report['accuracy']:.4f}", bar=MEDIUM_TRAIN_ACCURACY_BAR,
            planted_shuffled_labels_accuracy=f"{fault:.4f}", quarantined=len(quarantined))
        if launches != expected or not numbers["fit_device"].startswith("cuda") or len(quarantined) != 2:
            raise AssertionError(f"medium training launched {launches}, expected {expected}; quarantined {quarantined}")
        if not report["accuracy"] >= MEDIUM_TRAIN_ACCURACY_BAR or not fault < 0.5:
            raise AssertionError(f"test accuracy {report['accuracy']}, with shuffled labels {fault}")

        cached, second, cached_launches, cached_wall = _train_run(
            "medium", settings, lambda: _TrainProbe(backend, "_encode_batch"), counters)
        cached_numbers = _train_numbers("medium-train-cached", cached, second, cached_launches, cached_wall, 3.0)
        same_rows = _same_rows(first, second)
        if (cached["cache_probes"] != {"hits": 96, "misses": 0} or second.encodes["train"] or not same_rows
                or cached_launches["flash_attention_fwd"] != layers * second.smoke_probes()):
            raise AssertionError(f"the cached medium run: {cached['cache_probes']}, {cached_launches}, {same_rows}")
        rows_bf16 = _masked_rows_check("medium-train-kernels", backend, settings, "medium", files, counters)
        _serve_held_out(root, "medium", settings, backend, report)

        # A fresh cache folder; the first training encode after the smoke planted non-finite.
        planted = {"armed": False, "fired": False}
        encode = backend._encode_batch

        def planted_encode(batch, lengths):
            out = encode(batch, lengths)
            if planted["armed"] and not planted["fired"]:
                planted["fired"] = True
                return out * float("nan")
            return out

        backend._encode_batch = planted_encode
        try:
            retry_settings = build_settings({**_training_env(root, "tmp-retry"), "SER_ENABLE_MEDIUM_PROFILE": "1"})
            retry, third, retry_launches, retry_wall = _train_run(
                "medium", retry_settings,
                lambda: _TrainProbe(backend, "_encode_batch", arm=lambda: planted.update(armed=True)), counters)
        finally:
            del backend._encode_batch  # the class's method again
        dtypes = [dtype for _, dtype in third.encodes["train"]]
        f32_calls = dtypes.count("torch.float32")
        say("medium-train-retry", wall_s=f"{retry_wall:.3f}", encode_dtypes=json.dumps(dtypes),
            k2_f32_launches=retry_launches["flash_attention_f32"], k2_launches=retry_launches["flash_attention_fwd"],
            backend_dtype_after=str(backend.dtype), test_accuracy=f"{retry['accuracy']:.4f}")
        # The planted call itself ran in bf16; its retry and every later call in float32.
        if (not planted["fired"] or dtypes[0] != "torch.bfloat16" or set(dtypes[1:]) != {"torch.float32"}
                or retry_launches["flash_attention_f32"] != layers * f32_calls
                or retry_launches["flash_attention_fwd"] != layers * (third.smoke_probes() + 1)
                or backend.dtype != torch.float32):
            raise AssertionError(f"the float32 retry inside training: {dtypes}, {retry_launches}, {backend.dtype}")
        rows_f32 = _masked_rows_check("medium-train-kernels-f32", backend, retry_settings, "medium", files, counters)
    wall_s = time.perf_counter() - phase_started
    say("medium-train-wall", wall_s=f"{wall_s:.1f}")
    return {"numbers": numbers, "cached": cached_numbers, "launches": launches, "retry_launches": retry_launches,
            "shuffled_accuracy": fault, "rows_bf16": rows_bf16, "rows_f32": rows_f32, "wall_s": wall_s}


def phase_research_train() -> dict:
    """``api.train(profile="accurate-research")`` with a full-width emotion2vec layout (seeded random
    weights, bf16) on the same corpus: refused in readiness with the license gate shut (no encode), then
    trained behind the opened gate through masked K2, with the planted shuffled-label fault, its rows held
    against the plain attention, and served."""
    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.models.training_orchestration import TrainingNotReadyError
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    counters = (attention.COUNTER, attention.F32_COUNTER, log_mel.FUSED_COUNTER)
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_research_train_") as tmp:
        root = Path(tmp)
        files = _training_corpus(root / "dataset")
        # No consent recorded anywhere this run could read: only the env allowlist opens the gate.
        os.environ["SER_RESTRICTED_BACKENDS_CONSENT_FILE"] = str(root / "no_consent.json")
        env = {**_training_env(root, "tmp"), "SER_ENABLE_ACCURATE_RESEARCH_PROFILE": "1"}
        for counter in counters:
            counter.launches = 0
        try:
            api.train(profile="accurate-research", settings=build_settings(env))
        except TrainingNotReadyError as err:
            refused = str(err)
        else:
            raise AssertionError("accurate-research training ran with the license gate shut")
        refused_launches = sum(counter.launches for counter in counters)
        say("research-train-gate", refused=json.dumps(refused[:120]), launches=refused_launches)
        if "restricted" not in refused or refused_launches:
            raise AssertionError(f"the shut gate: {refused!r}, {refused_launches} launches")

        settings = build_settings({**env, "SER_ENABLE_RESTRICTED_BACKENDS": "1",
                                   "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"})
        backend = encoders.build_encoder_backend("accurate-research", settings)
        layers = backend._config.num_hidden_layers
        report, first, launches, wall = _train_run(
            "accurate-research", settings, lambda: _TrainProbe(backend, "_encode_batch"), counters)
        numbers = _train_numbers("research-train", report, first, launches, wall, 3.0)
        fault = _shuffled_label_accuracy(settings, first)
        calls = numbers["smoke_probes"] + numbers["train_encode_calls"]
        expected = {"flash_attention_fwd": layers * calls, "flash_attention_f32": 0, "stft_power_mel_log": 0}
        say("research-train-check", encode_calls=calls, masked_k2_expected=layers * calls,
            test_accuracy=f"{report['accuracy']:.4f}", bar=MEDIUM_TRAIN_ACCURACY_BAR,
            planted_shuffled_labels_accuracy=f"{fault:.4f}", backend=report["backend_id"],
            model=report["backend_model_id"])
        if launches != expected or not numbers["fit_device"].startswith("cuda"):
            raise AssertionError(f"accurate-research training launched {launches}, expected {expected}")
        if not report["accuracy"] >= MEDIUM_TRAIN_ACCURACY_BAR or not fault < 0.5:
            raise AssertionError(f"test accuracy {report['accuracy']}, with shuffled labels {fault}")
        rows = _masked_rows_check("research-train-kernels", backend, settings, "accurate-research", files, counters)
        _serve_held_out(root, "accurate-research", settings, backend, report)
    wall_s = time.perf_counter() - phase_started
    say("research-train-wall", wall_s=f"{wall_s:.1f}")
    return {"numbers": numbers, "launches": launches, "shuffled_accuracy": fault, "rows": rows, "wall_s": wall_s}


# --------------------------------------------------------------------------- #
# The distributed layer: dist-train and batch-infer
# --------------------------------------------------------------------------- #


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _world_of_one() -> str:
    """``initialize_distributed()`` through ``SER_DIST_*`` with one process: an NCCL group of 1 on the card."""
    import torch.distributed as dist

    from ser_tpu_torch.parallel.distributed import initialize_distributed

    os.environ.update({"SER_DIST_COORDINATOR": f"127.0.0.1:{_free_port()}", "SER_DIST_NUM_PROCESSES": "1",
                       "SER_DIST_PROCESS_ID": "0"})
    if not initialize_distributed():
        raise AssertionError("initialize_distributed() did not form a group from SER_DIST_*")
    backend = dist.get_backend()
    if backend != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"expected an NCCL group of 1, got {backend} of {dist.get_world_size()}")
    return backend


def _max_abs_diff(ours: dict, reference: dict) -> float:
    return max((ours[name].float() - reference[name].float()).abs().max().item() for name in reference)


def _train_state(encoder, head) -> dict:
    from ser_tpu_torch.parallel import train_step as ts

    return {name: tensor.detach().clone() for name, tensor in ts.train_parameters(encoder, head).items()}


def phase_dist_train(train: dict) -> dict:
    """``bench.py``'s train lane through the distributed layer on one card: an NCCL group of 1 from
    ``SER_DIST_*``, ``build_mesh`` (1x1), ``make_sharded_train_loop(encoder, mesh, ...)``; held to the
    one-device loop from the same start, a planted fault, a checkpoint round trip at the mesh."""
    import torch

    from ser_tpu_torch.parallel.mesh import build_mesh

    backend = _world_of_one()
    mesh = build_mesh()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _dist_train(train, backend, mesh, deterministic)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _dist_train(train: dict, backend: str, mesh, timing_deterministic: bool) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.ops import log_mel
    from ser_tpu_torch.parallel import checkpoint, optim
    from ser_tpu_torch.parallel import train_step as ts

    config, cuda = wm.WhisperConfig(), torch.device("cuda")
    batch, k_steps = 4, 3
    state = wm.random_whisper_encoder_state(config, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    waves = torch.from_numpy((0.1 * rng.standard_normal((k_steps, batch, wm.CHUNK_SAMPLES))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 8, size=(k_steps, batch)).astype(np.int32))

    def start(target, optimizer):
        """A fresh encoder from the seeded state on ``target`` (the card, or the mesh)."""
        encoder = wm.build_trainable_whisper_encoder(
            config, {name: tensor.clone() for name, tensor in state.items()}, device=cuda,
            compute_dtype=torch.bfloat16, remat=True, remat_policy="dots",
            mesh=target if target is mesh else None)
        place, run_steps, optimizer = ts.make_sharded_train_loop(encoder, target, optimizer)
        head, placed_waves, placed_labels = place(_train_head(config), waves, labels)
        opt_state = ts.place_optimizer_state(target, optimizer.init(ts.train_parameters(encoder, head)))
        return encoder, head, opt_state, run_steps, placed_waves, placed_labels

    ref_encoder, ref_head, ref_state, ref_run, w, lab = start(cuda, optim.adafactor(1e-4))
    ref_head, ref_state, reference_losses = ref_run(ref_head, ref_state, w, lab)
    reference = _train_state(ref_encoder, ref_head)

    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.BWD_COUNTER)
    encoder, head, opt_state, run_steps, w, lab = start(mesh, optim.adafactor(1e-4))
    for counter in counters:
        counter.launches = 0
    head, opt_state, losses = run_steps(head, opt_state, w, lab)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    ours = _train_state(encoder, head)
    loss_diff = (losses - reference_losses).abs().max().item()
    param_diff = _max_abs_diff(ours, reference)
    same_bits = loss_diff == 0 and all(torch.equal(ours[n], reference[n]) for n in reference)

    # A checkpoint at the mesh after these 3 steps, then one more step, uninterrupted and restored.
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_dist_train_") as tmp:
        path = Path(tmp) / "trainstate"
        started = time.perf_counter()
        checkpoint.save_train_state(path, encoder_params=encoder.state_dict(), head_params=head,
                                    opt_state=opt_state, step=k_steps, mesh=mesh)
        save_s = time.perf_counter() - started
        head, opt_state, next_loss = run_steps(head, opt_state, w[:1], lab[:1])
        uninterrupted = _train_state(encoder, head)

        # Timed in turns on the live states (warm), K steps a call: one device, mesh, mesh, one device,
        # with cuDNN's algorithms chosen as phase train chooses them.
        routes = {"one_device": [ref_head, ref_state, ref_run], "mesh": [head, opt_state, run_steps]}
        turns: dict[str, list[float]] = {"one_device": [], "mesh": []}
        torch.backends.cudnn.deterministic = timing_deterministic
        try:
            for route in ("one_device", "mesh", "mesh", "one_device"):
                route_head, route_state, route_run = routes[route]
                torch.cuda.synchronize()
                started = time.perf_counter()
                route_head, route_state, timed_losses = route_run(route_head, route_state, w, lab)
                timed_losses = timed_losses.cpu()
                turns[route].append((time.perf_counter() - started) / k_steps * 1e3)
                routes[route][:2] = [route_head, route_state]
            # The collective path's own time: the data-axis mean of K more mesh steps, synchronized
            # around, in buckets and with one collective per tensor (a bucket limit of one byte).
            data_mean_ms = {}
            for label, limit in (("buckets", ts.BUCKET_BYTES), ("per_tensor", 1)):
                spans: dict[str, float] = {}
                restore = _spans_around(spans, [(ts, "_data_mean")])
                bucket_bytes, ts.BUCKET_BYTES = ts.BUCKET_BYTES, limit
                try:
                    run_steps(*routes["mesh"][:2], w, lab)
                finally:
                    ts.BUCKET_BYTES = bucket_bytes
                    _restore(restore)
                data_mean_ms[label] = spans["_data_mean"] / k_steps * 1e3
        finally:
            torch.backends.cudnn.deterministic = True
        ms_per_step, one_device_ms = statistics.mean(turns["mesh"]), statistics.mean(turns["one_device"])
        del encoder, head, opt_state, ours, routes, ref_encoder, ref_head, ref_state
        torch.cuda.empty_cache()

        encoder, _, _, run_steps, w, lab = start(mesh, optim.adafactor(1e-4))
        started = time.perf_counter()
        params, head, opt_state, step = checkpoint.restore_train_state(path, map_location=cuda, mesh=mesh)
        encoder.load_state_dict(params, strict=True)
        head = {name: tensor.requires_grad_() for name, tensor in head.items()}
        restore_s = time.perf_counter() - started
        head, opt_state, resumed_loss = run_steps(head, opt_state, w[:1], lab[:1])
        resumed = _train_state(encoder, head)
        resume_diff = max(_max_abs_diff(resumed, uninterrupted), (resumed_loss - next_loss).abs().max().item())
        del encoder, head, opt_state, params, resumed, uninterrupted

    # Planted fault: one gradient scaled by 2 before the update. adafactor's first step is blind to a
    # gradient's scale (v = g² + eps, so the update is g/|g|); the fault is planted at the second step.
    base = optim.adafactor(1e-4)
    planted_name = "encoder.layers.0.attn.q.weight"

    def planted_apply(params, grads, opt_state, layout=None):
        if opt_state["count"] == 1:
            grads = {**grads, planted_name: grads[planted_name] * 2}
        return base.apply(params, grads, opt_state, layout)

    encoder, head, opt_state, run_steps, w, lab = start(mesh, dataclasses.replace(base, apply=planted_apply))
    head, opt_state, fault_losses = run_steps(head, opt_state, w, lab)
    fault_diff = _max_abs_diff(_train_state(encoder, head), reference)
    del encoder, head, opt_state, reference, state
    torch.cuda.empty_cache()

    say("dist-train", backend=backend, mesh="1x1", batch=batch, steps=k_steps, ms_per_step=f"{ms_per_step:.2f}",
        one_device_ms_per_step=f"{one_device_ms:.2f}", turns=json.dumps({k: [round(v, 2) for v in t]
                                                                          for k, t in turns.items()}),
        collective_cost_ms_per_step=f"{ms_per_step - one_device_ms:.2f}",
        data_mean_ms_per_step=json.dumps({k: round(v, 2) for k, v in data_mean_ms.items()}),
        train_ms_per_step=f"{train['ms_per_step']:.2f}",
        losses=json.dumps([round(x, 6) for x in losses.cpu().tolist()]),
        one_device_losses=json.dumps([round(x, 6) for x in reference_losses.cpu().tolist()]),
        same_bits=same_bits, loss_max_abs_diff=f"{loss_diff:.3g}", param_max_abs_diff=f"{param_diff:.3g}",
        limit=DIST_TRAIN_ATOL, launches=json.dumps(launches), train_launches=json.dumps(train["launches"]))
    say("dist-train-checkpoint", save_s=f"{save_s:.2f}", restore_s=f"{restore_s:.2f}", restored_step=step,
        next_loss=f"{next_loss.item():.6f}", resumed_loss=f"{resumed_loss.item():.6f}",
        max_abs_diff=f"{resume_diff:.3g}", limit=DIST_TRAIN_ATOL)
    say("dist-train-fault", planted=f"{planted_name} gradient x2 at step 2",
        param_max_abs_diff=f"{fault_diff:.3g}", limit=DIST_TRAIN_ATOL,
        losses=json.dumps([round(x, 6) for x in fault_losses.cpu().tolist()]))
    if not (loss_diff <= DIST_TRAIN_ATOL and param_diff <= DIST_TRAIN_ATOL):
        raise AssertionError(f"the mesh loop parts from the one-device loop: loss {loss_diff}, params {param_diff}")
    if step != k_steps or not resume_diff <= DIST_TRAIN_ATOL:
        raise AssertionError(f"the restored step parts from the uninterrupted one: {resume_diff} (step {step})")
    if not fault_diff > DIST_TRAIN_ATOL:
        raise AssertionError(f"the limit missed the planted fault: {fault_diff}")
    if launches != train["launches"]:
        raise AssertionError(f"dist-train launched {launches}, phase train {train['launches']}")
    if not torch.isfinite(timed_losses).all():
        raise AssertionError(f"non-finite losses: {timed_losses.tolist()}")
    return {"launches": launches, "ms_per_step": ms_per_step, "one_device_ms_per_step": one_device_ms,
            "data_mean_ms_per_step": data_mean_ms, "same_bits": same_bits}


def _batch_rows_check(label: str, rows, references: dict, prob_limit: float, *, exact_segments: bool) -> dict:
    """Each decoded row against ``api.infer`` on its file: segments (exactly, or label for label where
    the reference's top-two margin is wider than twice the limit) and frame probabilities."""
    worst, segments_differ, frames_differ = 0.0, 0, 0
    for row in rows:
        reference = references.get(row.file_path)
        if reference is None:
            continue
        ours, theirs = row.result, reference.detailed_result
        if len(ours.frames) != len(theirs.frames):
            raise AssertionError(f"{label}: {row.file_path} has {len(ours.frames)} frames, api.infer "
                                 f"{len(theirs.frames)}")
        for mine, ref in zip(ours.frames, theirs.frames):
            worst = max(worst, max(abs(mine.probabilities[k] - p) for k, p in ref.probabilities.items()))
            top = sorted(ref.probabilities.values(), reverse=True)
            if mine.emotion != ref.emotion:
                frames_differ += 1
                if top[0] - top[1] > 2 * prob_limit:
                    raise AssertionError(f"{label}: {row.file_path} frame at {ref.start_seconds} s is "
                                         f"{mine.emotion}, api.infer {ref.emotion} (margin {top[0] - top[1]:.3g})")
        if [(s.emotion, s.start_seconds, s.end_seconds) for s in ours.segments] != [
                (s.emotion, s.start_seconds, s.end_seconds) for s in theirs.segments]:
            segments_differ += 1
            if exact_segments:
                raise AssertionError(f"{label}: {row.file_path} segments differ from api.infer's")
    if not worst <= prob_limit:
        raise AssertionError(f"{label}: probabilities {worst} from api.infer's, limit {prob_limit}")
    return {"prob_max_abs_diff": worst, "segments_differ": segments_differ, "frames_differ": frames_differ}


def phase_batch_infer() -> dict:
    """``infer_many`` over 12 WAVs (four each of 10, 45 and 75 s) and a corrupt file, under the NCCL
    group of 1 (the gather path): accurate at full width (K1, K2) and medium (masked K2), each row
    against ``api.infer`` on the same file."""
    import torch
    import torch.distributed as dist

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.repr import encode_util
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel
    from ser_tpu_torch.parallel import batch_inference
    from ser_tpu_torch.parallel.batch_inference import infer_many

    if not dist.is_initialized():
        _world_of_one()
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    readings = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_batch_") as tmp:
        root = Path(tmp)
        files, seconds = [], []
        for index, length in enumerate(BATCH_CLIP_SECONDS):
            clip = root / f"clip_{index:02d}_{int(length)}s.wav"
            _write_clip(clip, length, 48000, seed=20 + index)
            files.append(str(clip))
            seconds.append(length)
        corrupt = root / "corrupt.wav"
        corrupt.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
        paths = files[:6] + [str(corrupt)] + files[6:]
        audio_s = sum(seconds)
        for profile, feature_size, backend_id, model_id in (
                ("accurate", 2 * 1280, "jax_whisper_encoder", "openai/whisper-large-v3"),
                ("medium", 2 * 1024, "jax_xlsr", MEDIUM_MODEL_ID)):
            _write_head_envelope(root / "models" / profile_artifact_file_name(profile=profile, model_id=model_id),
                                 feature_size=feature_size, backend_id=backend_id, profile=profile,
                                 model_id=model_id)
            settings = build_settings({"SER_ENABLE_ACCURATE_PROFILE": "1", "SER_ENABLE_MEDIUM_PROFILE": "1",
                                       "SER_MODELS_FOLDER": str(root / "models"),
                                       "SER_CACHE_DIR": str(root / "cache")})
            for counter in counters:
                counter.launches = 0
            torch.cuda.synchronize()
            started = time.perf_counter()
            rows = infer_many(paths, profile=profile, settings=settings)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - started
            launches = {c.name: c.launches for c in counters}
            started = time.perf_counter()
            infer_many(paths, profile=profile, settings=settings)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - started
            # Once more, split on the host clock: the decode (summed over its threads), the
            # encode, and the per-clip window, pool, predict and postprocess pass.
            spans: dict[str, float] = {}
            restore = _spans_around(spans, [(batch_inference, "read_audio_file"), (encode_util, "encode_clips"),
                                            (batch_inference, "run_windowed_inference_once")])
            try:
                started = time.perf_counter()
                infer_many(paths, profile=profile, settings=settings)
                split_s = time.perf_counter() - started
            finally:
                _restore(restore)
            references = {path: api.infer(path, profile=profile, include_transcript=False, settings=settings)
                          for path in files}
            if [row.file_path for row in rows] != paths:
                raise AssertionError(f"{profile}: rows out of input order")
            bad = [row for row in rows if row.result is None]
            if [row.file_path for row in bad] != [str(corrupt)] or not bad[0].error:
                raise AssertionError(f"{profile}: failed rows {[(r.file_path, r.error) for r in bad]}")
            exact = profile == "accurate"
            check = _batch_rows_check(f"batch-infer-{profile}", rows, references,
                                      BATCH_ACCURATE_PROB_ATOL if exact else BATCH_MEDIUM_PROB_ATOL,
                                      exact_segments=exact)
            say(f"batch-infer-{profile}", files=len(files), corrupt_error=json.dumps(bad[0].error[:80]),
                audio_s=audio_s, cold_s=f"{cold_s:.3f}", warm_s=f"{warm_s:.3f}",
                files_per_s=f"{len(files) / warm_s:.2f}", audio_s_per_s=f"{audio_s / warm_s:.1f}",
                cold_files_per_s=f"{len(files) / cold_s:.2f}", launches=json.dumps(launches),
                prob_max_abs_diff=f"{check['prob_max_abs_diff']:.3g}",
                prob_limit=BATCH_ACCURATE_PROB_ATOL if exact else BATCH_MEDIUM_PROB_ATOL,
                segments_differ=check["segments_differ"], frames_differ=check["frames_differ"])
            say(f"batch-infer-{profile}-split", wall_s=f"{split_s:.3f}",
                **{f"{name}_s": f"{value:.3f}" for name, value in spans.items()})
            readings[profile] = {"launches": launches, "files_per_s": len(files) / warm_s,
                                 "audio_s_per_s": audio_s / warm_s, **check}
    accurate, medium = readings["accurate"]["launches"], readings["medium"]["launches"]
    expected = {"stft_power_mel_log": len(files), "power_mel_log": 0, "flash_attention_fwd": 32 * len(files),
                "flash_attention_f32": 0}
    if accurate != expected:
        raise AssertionError(f"batch-infer accurate launched {accurate}, expected {expected}")
    # chunked_encode_many: the 12 clips' 15 s chunks (4 clips of 10 s, and the tails of the 45 and 75 s
    # clips) in one batch of the 15 s bucket, their 12 full 30 s chunks in one of the 30 s bucket.
    expected = {"stft_power_mel_log": 0, "power_mel_log": 0, "flash_attention_fwd": 24 * 2,
                "flash_attention_f32": 0}
    if medium != expected:
        raise AssertionError(f"batch-infer medium launched {medium}, expected {expected}")
    return readings


def _music_clip(seconds: float, sample_rate: int, seed: int):
    """Music-like audio: a looping bass and chord with a beat, a gliding voice-like tone, noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    beat = (np.sin(2 * np.pi * 2.0 * t) > 0).astype(np.float64)
    chord = sum(np.sin(2 * np.pi * f * t) for f in (110.0, 220.0, 277.2, 329.6)) / 4
    voice = np.sin(2 * np.pi * (300 + 60 * np.sin(2 * np.pi * 0.5 * t)) * t) * (np.sin(2 * np.pi * 0.1 * t) > -0.3)
    audio = 0.4 * chord * (0.6 + 0.4 * beat) + 0.3 * voice + 0.03 * rng.standard_normal(t.size)
    return (0.8 * audio / np.abs(audio).max()).astype(np.float32)


def _ispec_reading_dc_imag(z, cfg, length):
    """``demucs_v4._ispec`` without its zeroing of the DC bin's imaginary part (a planted fault)."""
    import torch
    import torch.nn.functional as F

    from ser_tpu_torch.models import demucs_v4 as tdm

    *lead, freqs, le = z.shape
    pad = cfg.hop // 2 * 3
    total = cfg.hop * math.ceil(length / cfg.hop) + 2 * pad
    z = F.pad(z.reshape(-1, freqs, le), (2, 2, 0, 1))
    x = torch.istft(z, cfg.nfft, cfg.hop, window=tdm._window(cfg.nfft, z), normalized=True, center=True,
                    length=total)
    return x[:, pad : pad + length].reshape(*lead, length)


def _separator_checks(tree, config, npz_root: Path) -> dict:
    """(a)-(c): htdemucs and the U-Net at their published widths, one segment each, the card's float32
    forward against a float64 forward of the same module on the card, each with a planted fault."""
    import numpy as np
    import torch

    from ser_tpu_torch.models import convert
    from ser_tpu_torch.models import demucs_v4 as tdm
    from ser_tpu_torch.models import separation as tsep

    cuda = torch.device("cuda")
    results: dict = {}

    def rel64(value, reference) -> float:
        return ((value.double() - reference).norm() / reference.norm()).item()

    # htdemucs: one 7.8 s stereo segment at 44.1 kHz.
    vocals = config.sources.index("vocals")
    mix = np.repeat(_music_clip(config.segment_seconds, config.sample_rate, seed=1)[None, None, :],
                    config.audio_channels, axis=1)[:, :, : config.segment_samples]
    params32 = convert.demucs_params(tree, device=cuda)
    params64 = convert.demucs_params(tree, device=cuda, dtype=torch.float64)
    mix32 = torch.from_numpy(np.ascontiguousarray(mix)).to(cuda)
    started = time.perf_counter()
    with torch.inference_mode():
        reference = tdm.demucs_forward(params64, mix32.double(), config)[:, vocals].mean(dim=1)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - started
    del params64
    ours = tdm.vocals_forward(params32, mix32, config, vocals)
    gamma = params32["crosstransformer"]["layers"][0]["gamma_1"]
    gamma.mul_(1.01)
    planted = tdm.vocals_forward(params32, mix32, config, vocals)
    gamma.div_(1.01)
    ispec = tdm._ispec
    tdm._ispec = _ispec_reading_dc_imag
    try:
        planted_dc = tdm.vocals_forward(params32, mix32, config, vocals)
    finally:
        tdm._ispec = ispec
    results["demucs"] = {"rel_l2_err": rel64(ours, reference), "planted_rel_l2_err": rel64(planted, reference),
                         "dc_planted_rel_l2_err": rel64(planted_dc, reference), "float64_forward_s": f64_s,
                         "finite": bool(torch.isfinite(ours).all())}
    del reference, ours, planted, planted_dc, params32
    torch.cuda.empty_cache()

    # The U-Net at SeparatorConfig() defaults: one 10 s mono segment at 16 kHz.
    unet_config = tsep.SeparatorConfig()
    unet_tree = tsep.init_separator_params(unet_config, seed=0)
    unet_path = npz_root / "unet.npz"
    tsep.save_separator_params(unet_tree, unet_path, config=unet_config)
    loaded, loaded_config = tsep.load_separator_params(unet_path)
    model32 = tsep.build_separator(loaded, loaded_config, device=cuda)
    model64 = tsep.build_separator(loaded, loaded_config, device=cuda).double()
    segment = torch.from_numpy(_music_clip(unet_config.segment_seconds, unet_config.sample_rate, seed=2)[None]).to(cuda)
    with torch.inference_mode():
        reference = tsep.separate_segments(model64, segment.double())
        with tdm.strict_float32(cuda):
            ours = tsep.separate_segments(model32, segment)
            norm = model32.dec_norm[1].weight
            norm.mul_(1.01)
            planted = tsep.separate_segments(model32, segment)
            norm.div_(1.01)
    results["unet"] = {"rel_l2_err": rel64(ours, reference), "planted_rel_l2_err": rel64(planted, reference),
                       "finite": bool(torch.isfinite(ours).all())}
    results["unet_path"] = unet_path
    for name, bound in (("demucs", SEPARATE_DEMUCS_REL_L2_BOUND), ("unet", SEPARATE_UNET_REL_L2_BOUND)):
        check = results[name]
        planted = {key: value for key, value in check.items() if key.endswith("planted_rel_l2_err")}
        say(f"separate-{name}-accuracy", rel_l2_err=f"{check['rel_l2_err']:.3e}", bound=bound,
            **{key: f"{value:.3e}" for key, value in planted.items()},
            **({"float64_forward_s": f"{check['float64_forward_s']:.2f}"} if name == "demucs" else {}))
        if not check["finite"] or not check["rel_l2_err"] <= bound:
            raise AssertionError(f"{name}: float32 vocals {check['rel_l2_err']:.3e} from float64, bound {bound}")
        for key, value in planted.items():
            if not value > bound:
                raise AssertionError(f"{name}: the planted fault {key} ({value:.3e}) passed the bound")
    return results


def phase_separate() -> dict:
    """htdemucs and the U-Net at published widths, then the separated 60 s transcribe and its export."""
    import csv

    import numpy as np
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.config.schema import TimelineConfig
    from ser_tpu_torch._internal.transcript.whisper_backend import WhisperTranscriber
    from ser_tpu_torch._internal.utils import denoise, source_separation, subtitles
    from ser_tpu_torch._internal.utils import timeline as timeline_utils
    from ser_tpu_torch._internal.utils.audio_io import write_wav
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import demucs_v4 as tdm
    from ser_tpu_torch.models import separation as tsep
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_separate_") as tmp:
        root = Path(tmp)
        # (a) htdemucs at the published widths, the port's synthetic weights (seed 0), staged as .npz.
        config = tdm.DemucsV4Config()
        started = time.perf_counter()
        tree = tdm.init_demucs_params(config, seed=0)
        demucs_path = root / "htdemucs.npz"
        tdm.save_demucs_npz(tree, demucs_path, config=config)
        tree, config = tdm.load_demucs_npz(demucs_path)
        say("separate-stage", demucs_params=sum(int(np.asarray(x).size) for x in _leaves(tree)),
            demucs_npz_mb=f"{demucs_path.stat().st_size / 1e6:.1f}", seconds=f"{time.perf_counter() - started:.2f}")
        # (b), (c)
        checks = _separator_checks(tree, config, root)
        del tree

        # (d) WhisperTranscriber(use_demucs=True).transcribe on a 60 s WAV, once per separator.
        clip = root / "music_60s.wav"
        write_wav(clip, _music_clip(SEPARATE_CLIP_SECONDS, 44100, seed=3), 44100)
        model = _transcription_model()
        counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER,
                    attention.BWD_COUNTER, *dsk.COUNTERS)
        spans: dict[str, float] = {}
        dispatches: list[tuple[int, float]] = []

        def timed(name, fn, record=None):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                began = time.perf_counter()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - began
                spans[name] = spans.get(name, 0.0) + elapsed
                if record is not None:
                    record.append((len(args[1]), elapsed * 1e3))
                return result

            return wrapper

        originals = [(source_separation, "separate_vocals_auto"), (denoise, "spectral_gate_denoise"),
                     (tdm, "vocals_forward"), (tsep, "separate_segments")]
        saved = [(module, name, getattr(module, name)) for module, name in originals]
        source_separation.separate_vocals_auto = timed("separation", source_separation.separate_vocals_auto)
        denoise.spectral_gate_denoise = timed("spectral_gate", denoise.spectral_gate_denoise)
        tdm.vocals_forward = timed("device_forward", tdm.vocals_forward, dispatches)
        tsep.separate_segments = timed("device_forward", tsep.separate_segments, dispatches)
        model.transcribe_words = timed("transcribe", model.transcribe_words)
        runs: dict = {}
        try:
            for kind, path in (("demucs", demucs_path), ("unet", checks["unet_path"])):
                os.environ["SER_SEPARATION_MODEL_PATH"] = str(path)
                source_separation._NEURAL_PARAM_CACHE.clear()
                transcriber = WhisperTranscriber(model_name="large-v3", cache_root=root, device="cuda",
                                                 use_demucs=True, use_vad=False)
                transcriber._model = model
                run: dict = {}
                for attempt in ("cold", "warm"):
                    spans.clear()
                    dispatches.clear()
                    for counter in counters:
                        counter.launches = 0
                    torch.cuda.reset_peak_memory_stats()
                    started = time.perf_counter()
                    words = transcriber.transcribe(str(clip), language="en")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - started
                    run[attempt] = {"wall_s": wall, "spans": dict(spans), "dispatches": list(dispatches),
                                    "launches": {c.name: c.launches for c in counters},
                                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "words": words}
                _check_words(run["cold"]["words"], SEPARATE_CLIP_SECONDS)
                launches = run["cold"]["launches"]
                k3, k4, k5 = (launches[c.name] for c in dsk.COUNTERS)
                if (launches["stft_power_mel_log"], launches["power_mel_log"], launches["flash_attention_fwd"]) != (
                        1, 0, 32) or not (k3 == k4 == k5 and k3 > 0 and k3 % 32 == 0):
                    raise AssertionError(f"separated transcribe ({kind}) launches {launches}: expected K1 fused 1, "
                                         "K1 spectrum 0, K2 32 and K3-K5 32 a step")
                for attempt in ("cold", "warm"):
                    reading = run[attempt]
                    rows = [n for n, _ in reading["dispatches"]]
                    full = [ms for n, ms in reading["dispatches"] if n == max(rows)]
                    say(f"separate-transcribe-{kind}", attempt=attempt, clip_seconds=SEPARATE_CLIP_SECONDS,
                        wall_s=f"{reading['wall_s']:.4f}",
                        spans_s=json.dumps({k: round(v, 4) for k, v in reading["spans"].items()}),
                        dispatches=len(rows), rows=json.dumps(rows),
                        ms_per_full_dispatch=f"{statistics.mean(full):.2f}",
                        host_separation_s=f"{reading['spans']['separation'] - sum(ms for _, ms in reading['dispatches']) / 1e3:.4f}",
                        peak_gb=f"{reading['peak_gb']:.2f}", words=len(reading["words"]),
                        launches=json.dumps(reading["launches"]))
                runs[kind] = run
        finally:
            for module, name, original in saved:
                setattr(module, name, original)
            del model.transcribe_words
            os.environ.pop("SER_SEPARATION_MODEL_PATH", None)
            source_separation._NEURAL_PARAM_CACHE.clear()
        del model
        torch.cuda.empty_cache()

        # (e) The export: the demucs run's words and a warm accurate api.infer's emotion segments.
        artifact = root / "models" / profile_artifact_file_name(profile="accurate", model_id="openai/whisper-large-v3")
        _write_head_envelope(artifact, feature_size=2 * 1280)
        os.environ["SER_ALLOW_RANDOM_INIT"] = "1"
        os.environ["SER_RANDOM_INIT_SIZE"] = "full"
        settings = build_settings({"SER_ENABLE_ACCURATE_PROFILE": "1", "SER_MODELS_FOLDER": str(root / "models"),
                                   "SER_CACHE_DIR": str(root / "cache")})
        api.infer(clip, profile="accurate", include_transcript=False, settings=settings)
        started = time.perf_counter()
        execution = api.infer(clip, profile="accurate", include_transcript=False, settings=settings)
        infer_warm_s = time.perf_counter() - started
        _check_segments(execution, clip, SEPARATE_CLIP_SECONDS, "jax_whisper_encoder")
        timeline = timeline_utils.build_timeline(runs["demucs"]["cold"]["words"], execution.emotions)
        folder = TimelineConfig(folder=root / "transcripts")
        csv_path = timeline_utils.save_timeline_to_csv(timeline, str(clip), timeline_config=folder)
        cues = subtitles.timeline_to_subtitle_cues(timeline)
        written = {fmt: subtitles.save_timeline_to_subtitles(timeline, str(clip), subtitle_format=fmt,
                                                              timeline_config=folder)
                   for fmt in ("srt", "vtt", "ass")}
        with open(csv_path, newline="", encoding="utf-8") as handle:
            rows = list(csv.reader(handle))
        texts = {fmt: Path(path).read_text(encoding="utf-8") for fmt, path in written.items()}
        counts = {"csv_rows": len(rows) - 1, "srt_cues": texts["srt"].count(" --> "),
                  "vtt_cues": texts["vtt"].count(" --> "), "ass_cues": texts["ass"].count("\nDialogue: ")}
        say("separate-export", timeline_rows=len(timeline), cues=len(cues), infer_warm_s=f"{infer_warm_s:.4f}",
            **counts)
        if rows[0] != ["Time (s)", "Emotion", "Speech"] or [r[0] for r in rows[1:]] != [
                str(round(e.timestamp_seconds, 2)) for e in timeline]:
            raise AssertionError(f"the CSV's rows do not read back as the timeline: {rows[:3]}")
        if not cues or counts["csv_rows"] != len(timeline) or {
                counts["srt_cues"], counts["vtt_cues"], counts["ass_cues"]} != {len(cues)}:
            raise AssertionError(f"exported rows or cues {counts}, expected {len(timeline)} rows, {len(cues)} cues")
        if not texts["vtt"].startswith("WEBVTT\n") or not texts["ass"].startswith("[Script Info]\n"):
            raise AssertionError("a subtitle file lacks its header")
    return {"launches": runs["demucs"]["cold"]["launches"], "unet_launches": runs["unet"]["cold"]["launches"],
            "checks": {k: v for k, v in checks.items() if k != "unet_path"}}


# --------------------------------------------------------------------------- #
# The public constructors' default device
# --------------------------------------------------------------------------- #


def _tensor_devices(value) -> list[str]:
    """The device of every tensor in a result: nested containers, a loaded artifact's head, a head's layers."""
    import torch

    from ser_tpu_torch._internal.models.artifacts import LoadedModel
    from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

    if isinstance(value, torch.Tensor):
        return [value.device.type]
    if isinstance(value, LoadedModel):
        return _tensor_devices(value.model)
    if isinstance(value, TorchMLPClassifier):
        return [value.device.type, *_tensor_devices(value._layers)]
    if isinstance(value, dict):
        return [device for item in value.values() for device in _tensor_devices(item)]
    if isinstance(value, (list, tuple)):
        return [device for item in value for device in _tensor_devices(item)]
    return []


def phase_device_defaults() -> dict:
    """The eight public constructors that defaulted to the CPU, called with no ``device``/``map_location``
    and ``SER_TORCH_DEVICE`` unset (restored after): every tensor on the card, each seeded default draw the
    same bits as its ``device=cuda`` draw. No kernel runs here; the launch counts are read all the same."""
    import numpy as np
    import torch

    from ser_tpu_torch._internal.models import artifacts
    from ser_tpu_torch.models import attention, multitask_loss, wav2vec2
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel
    from ser_tpu_torch.parallel import checkpoint
    from ser_tpu_torch.parallel.mesh import build_mesh

    phase_started = time.perf_counter()
    cuda = torch.device("cuda")
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER,
                attention.BWD_COUNTER, *dsk.COUNTERS)
    requested = os.environ.pop("SER_TORCH_DEVICE", None)
    whisper_config, w2v_config = wm.WhisperConfig.tiny(), wav2vec2.Wav2Vec2Config.tiny()
    rng = np.random.default_rng(18)
    features = rng.standard_normal((32, 24)).astype(np.float32)
    labels = np.asarray(RAVDESS_LABELS[:4])[np.arange(32) % 4]
    (REPO / "build").mkdir(exist_ok=True)
    for counter in counters:
        counter.launches = 0
    try:
        with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_device_defaults_") as tmp:
            results = {
                "random_whisper_encoder_state": wm.random_whisper_encoder_state(whisper_config, seed=0),
                "random_whisper_decoder_state": wm.random_whisper_decoder_state(whisper_config, seed=0),
                "random_wav2vec2_state": wav2vec2.random_wav2vec2_state(w2v_config, seed=0),
                "init_multitask_loss_params": multitask_loss.init_multitask_loss_params(["primary_emotion", "vad"]),
            }
            head = TorchMLPClassifier(hidden_layer_sizes=(16,), max_iter=3, batch_size=8).fit(features, labels)
            results["TorchMLPClassifier"] = head
            results["TorchMLPClassifier.from_state"] = TorchMLPClassifier.from_state(head.get_state())
            artifact = Path(tmp) / "head.pkl"
            metadata = artifacts.build_artifact_metadata(feature_vector_size=features.shape[1],
                                                         training_samples=len(features), labels=list(head.classes_))
            artifacts.save_model_artifact(artifacts.build_model_artifact(head, metadata), artifact)
            results["load_model_artifact"] = artifacts.load_model_artifact(artifact)
            train_state = Path(tmp) / "train_state"
            encoder_state = results["random_whisper_encoder_state"]
            checkpoint.save_train_state(train_state, encoder_params=encoder_state,
                                        head_params={"w": torch.zeros(2 * whisper_config.d_model, 8)},
                                        opt_state={"mu": {n: torch.zeros_like(t) for n, t in encoder_state.items()},
                                                   "count": torch.zeros((), dtype=torch.int32)},
                                        step=3)
            results["restore_train_state"] = checkpoint.restore_train_state(train_state)
            results["restore_train_state(mesh)"] = checkpoint.restore_train_state(train_state, mesh=build_mesh())
        torch.cuda.synchronize()
    finally:
        if requested is not None:
            os.environ["SER_TORCH_DEVICE"] = requested
    launches = {c.name: c.launches for c in counters}
    devices = {site: _tensor_devices(value) for site, value in results.items()}
    misses = {site: sorted(set(found)) for site, found in devices.items() if set(found) != {"cuda"}}
    draws = {
        "random_whisper_encoder_state": wm.random_whisper_encoder_state(whisper_config, seed=0, device=cuda),
        "random_whisper_decoder_state": wm.random_whisper_decoder_state(whisper_config, seed=0, device=cuda),
        "random_wav2vec2_state": wav2vec2.random_wav2vec2_state(w2v_config, seed=0, device=cuda),
    }
    unequal = [site for site, explicit in draws.items()
               if results[site].keys() != explicit.keys()
               or not all(torch.equal(results[site][name], explicit[name]) for name in explicit)]
    restored_step = [results[site][3] for site in ("restore_train_state", "restore_train_state(mesh)")]
    wall_s = time.perf_counter() - phase_started
    sites = {site.split("(")[0] for site in results}
    say("device-defaults", seconds=f"{wall_s:.2f}", sites_checked=len(sites), calls=len(results),
        limit_s=DEVICE_DEFAULTS_WALL_LIMIT_S, tensors=sum(map(len, devices.values())), misses=json.dumps(misses),
        same_bits_as_device_cuda=json.dumps({site: site not in unequal for site in draws}),
        restored_steps=json.dumps(restored_step), launches=json.dumps(launches))
    if misses:
        raise AssertionError(f"a default device left tensors off the card: {misses}")
    if unequal:
        raise AssertionError(f"default draws differ from their device=cuda draws: {unequal}")
    if restored_step != [3, 3]:
        raise AssertionError(f"restored steps {restored_step}, expected [3, 3]")
    if wall_s > DEVICE_DEFAULTS_WALL_LIMIT_S:
        raise AssertionError(f"the device-defaults phase took {wall_s:.1f} s, over its {DEVICE_DEFAULTS_WALL_LIMIT_S} s")
    return {"launches": launches, "sites": len(sites), "wall_s": wall_s}


def phase_operator() -> dict:
    """The operator's path on the card: doctor and preflight, the profile checks, the fast latency benchmark
    and the fast-against-accurate quality gate, the last two inside a device trace."""
    import torch

    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch._internal.diagnostics import service
    from ser_tpu_torch._internal.runtime import commands, quality_gate_report, quality_gate_workflow
    from ser_tpu_torch._internal.runtime.benchmarks import benchmark_fast_predict
    from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError
    from ser_tpu_torch._internal.utils import native_audio
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file
    from ser_tpu_torch._internal.utils.profiling import TRACE_FILE_NAME, device_trace
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import log_mel, resample

    phase_started = time.perf_counter()
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER, resample.COUNTER)
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full"})
    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_operator_") as tmp:
        root = Path(tmp)
        files = _write_fast_corpus(root / "dataset", actors=OPERATOR_SPEAKERS, clips=1, seconds=3.0,
                                   sample_rate=48000)
        # The gate's corpus: the first four classes, and none of the planted corrupt files.
        for path in (root / "dataset").rglob("*.wav"):
            if path not in files or int(path.name.split("-")[2]) > OPERATOR_CLASSES:
                path.unlink()
        corpus = sorted((root / "dataset").rglob("*.wav"))
        models = root / "models"
        _write_head_envelope(models / "ser_model.pkl", feature_size=193, backend_id="handcrafted", profile="fast",
                             model_id=None)
        _write_head_envelope(models / profile_artifact_file_name(profile="accurate", model_id="openai/whisper-large-v3"),
                             feature_size=2 * 1280)
        clip = root / "clip_10s.wav"
        _write_clip(clip, 10.0, 48000, seed=50)
        settings = build_settings({"SER_DATASET_FOLDER": str(root / "dataset"), "SER_MODELS_FOLDER": str(models),
                                   "SER_CACHE_DIR": str(root / "cache"), "SER_TMP_FOLDER": str(root / "tmp"),
                                   "SER_ENABLE_ACCURATE_PROFILE": "1"})

        # 1. Doctor and preflight.
        started = time.perf_counter()
        doctor = service.run_doctor_diagnostics(settings=settings, include_noise_findings=True)
        preflight = api.run_startup_preflight(include_transcription_checks=True, settings=settings)
        doctor_s = time.perf_counter() - started
        findings = {f.code: f for f in doctor.findings}
        card = torch.cuda.get_device_name(0)
        say("operator-doctor", seconds=f"{doctor_s:.3f}",
            codes=json.dumps([f"{f.code}:{f.severity.value}" for f in doctor.findings]),
            preflight=json.dumps([f"{f.code}:{f.severity.value}" for f in preflight.findings]),
            accelerator=json.dumps(findings["accelerator"].message),
            native_audio=json.dumps(findings["environment.native_audio"].message))
        if doctor.has_blocking_findings or preflight.has_blocking_findings:
            raise AssertionError("blocking findings: " + service.render_report(doctor, style="brief"))
        if card not in findings["accelerator"].message or card not in preflight.findings[0].message:
            raise AssertionError(f"the accelerator finding does not name the card {card!r}")
        if findings["environment.native_audio"].message != "native C++ audio decoder available":
            raise AssertionError("the native audio library did not build on the card's machine")
        samples, _ = read_audio_file(str(corpus[0]))
        if samples.tobytes() != native_audio.decode_wav_mono_native(corpus[0].read_bytes())[0].tobytes():
            raise AssertionError("read_audio_file did not take the native decoder")

        # 2. Profile checks.
        api.load_profile("accurate", settings=settings)
        try:
            api.load_profile("accurate-research", settings=settings)
            raise AssertionError("load_profile passed a profile whose license gate is shut")
        except UnsupportedProfileError:
            pass
        _, code = commands.run_command(lambda: api.load_profile("accurate-research", settings=settings),
                                       label="load_profile", workflow="inference")
        say("operator-profiles", accurate="ok", research_gate_shut="UnsupportedProfileError", exit_code=code)
        if code != commands.EXIT_VALIDATION:
            raise AssertionError(f"the command runner mapped UnsupportedProfileError to {code}")

        # 3-5. The latency benchmark and the quality gate, inside a device trace.
        decisions = []
        evaluate = quality_gate_workflow.evaluate_candidate_gate

        def recorded_evaluation(**options):
            decisions.append(evaluate(**options))
            return decisions[-1]

        quality_gate_workflow.evaluate_candidate_gate = recorded_evaluation
        # A trace stopped with TEARDOWN_CUPTI=1 (set above for the earlier phases' host timings) left the
        # process hanging at exit on the card, 200 ops traced or 300000; with 0 it exits. Nothing is
        # timed after this phase, so this trace leaves CUPTI attached.
        os.environ["TEARDOWN_CUPTI"] = "0"
        try:
            with device_trace(root / "trace"):
                latency = benchmark_fast_predict(str(clip), runs=5, settings=settings)
                for counter in counters:
                    counter.launches = 0
                started = time.perf_counter()
                exit_code = quality_gate_workflow.run_quality_gate_workflow(settings=settings, candidate="accurate",
                                                                            folds=4)
                torch.cuda.synchronize()
                gate_s = time.perf_counter() - started
                launches = {counter.name: counter.launches for counter in counters}
        finally:
            quality_gate_workflow.evaluate_candidate_gate = evaluate
        say("operator-latency", card=json.dumps(nvidia_smi_line()), clip="clip_10s", runs=latency.runs,
            mean_s=f"{latency.mean_seconds:.4f}", median_s=f"{latency.median_seconds:.4f}",
            p95_s=f"{latency.p95_seconds:.4f}", min_s=f"{latency.min_seconds:.4f}",
            max_s=f"{latency.max_seconds:.4f}")
        if not 0.0 < latency.min_seconds <= latency.median_seconds <= latency.p95_seconds <= latency.max_seconds:
            raise AssertionError(f"latency statistics out of order: {latency}")

        payload = quality_gate_report.load_gate_report(models / quality_gate_report.DEFAULT_REPORT_FILE_NAME)
        decision = decisions[0] if len(decisions) == 1 else None
        windows = len(corpus) + OPERATOR_STABILITY_REQUESTS  # one 30 s window a 3 s clip
        expected = {"stft_power_mel_log": windows, "power_mel_log": 0, "flash_attention_fwd": 32 * windows,
                    "flash_attention_f32": 0, "resample_rows": windows}
        say("operator-gate", seconds=f"{gate_s:.3f}", exit_code=exit_code, clips=len(corpus),
            promote=None if decision is None else decision.promote,
            baseline=json.dumps(None if decision is None else vars(decision.baseline)),
            candidate=json.dumps(None if decision is None else vars(decision.candidate)),
            stability=json.dumps(None if decision is None or decision.candidate_stability is None
                                 else vars(decision.candidate_stability)),
            launches=json.dumps(launches), expected=json.dumps(expected))
        if exit_code != 0 or decision is None:
            raise AssertionError(f"the quality gate exited {exit_code} after {len(decisions)} evaluations")
        if decision.candidate_stability is None:
            raise AssertionError("the gate's stability pass failed (candidate_stability is None)")
        if payload is None or (payload["promote"], payload["reasons"], payload["candidate_stability"]) != (
                decision.promote, list(decision.reasons), vars(decision.candidate_stability)):
            raise AssertionError(f"the report read back {payload} against the decision {decision}")
        if launches != expected:
            raise AssertionError(f"the gate launched {launches}, expected {expected}")

        trace_path = root / "trace" / TRACE_FILE_NAME
        trace = trace_path.read_text(encoding="utf-8")
        symbols = {name: trace.count(name) for name in ("stft_power_mel_log_kernel", "flash_attention_fwd_kernel")}
        say("operator-trace", megabytes=f"{trace_path.stat().st_size / 1e6:.1f}", symbol_mentions=json.dumps(symbols))
        if not all(symbols.values()):
            raise AssertionError(f"the device trace does not name both kernels: {symbols}")
    wall_s = time.perf_counter() - phase_started
    say("operator-wall", wall_s=f"{wall_s:.1f}", limit_s=OPERATOR_WALL_LIMIT_S)
    if wall_s > OPERATOR_WALL_LIMIT_S:
        raise AssertionError(f"the operator phase took {wall_s:.1f} s, over its {OPERATOR_WALL_LIMIT_S} s")
    return {"launches": launches, "latency": vars(latency), "wall_s": wall_s}


def _cli_environment(root: Path) -> dict[str, str]:
    """The command line's variables: every folder under ``root``, seeded full-width weights, the card by default."""
    return {
        "SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "full", "SER_ENABLE_ACCURATE_PROFILE": "1",
        "SER_DATA_DIR": str(root / "data"), "SER_MODELS_FOLDER": str(root / "models"),
        "SER_TMP_FOLDER": str(root / "tmp"), "SER_CACHE_DIR": str(root / "cache"),
        "SER_DATASET_FOLDER": str(root / "dataset"), "SER_DATASET_REGISTRY_ROOT": str(root / "registry"),
        "SER_DATASET_CONSENTS_FILE": str(root / "consents.json"),
        "SER_RESTRICTED_BACKENDS_CONSENT_FILE": str(root / "restricted.json"),
        "SER_TRANSCRIPTS_FOLDER": str(root / "transcripts"), "LOG_LEVEL": "WARNING",
    }


def phase_cli() -> dict:
    """The command line, ``ser_tpu_torch.__main__.main(argv)`` in this process (so that the launch counters
    read its kernels), at large-v3's full width with seeded random weights: consents, the data subcommands
    on a RAVDESS-named corpus, ``--train --profile accurate`` (dry run, then the head), ``--file`` with the
    trained head (cold, then warm with the timeline's CSV and subtitles), ``--train --repair`` and
    ``doctor``; then ``python -m ser_tpu_torch --file ...`` in a subprocess. Every exit code must be 0."""
    import io

    import torch

    import ser_tpu_torch.__main__ as cli
    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.data.manifest import read_manifest_jsonl
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER,
                attention.BWD_COUNTER, *dsk.COUNTERS)
    steps: dict[str, dict] = {}
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    saved_env = dict(os.environ)
    executions = []
    infer = api.infer

    def recorded_infer(*args, **kwargs):
        executions.append(infer(*args, **kwargs))
        return executions[-1]

    def run(step: str, argv: list[str]) -> str:
        """One ``main(argv)``: its launches, wall seconds and standard output; a non-zero exit fails the phase."""
        for counter in counters:
            counter.launches = 0
        out = io.StringIO()
        started = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - started
        launches = {counter.name: counter.launches for counter in counters if counter.launches}
        steps[step] = {"seconds": round(seconds, 4), "launches": launches}
        say("cli-step", step=step, exit_code=code, seconds=f"{seconds:.4f}", launches=json.dumps(launches))
        if code != 0:
            raise AssertionError(f"`{' '.join(argv)}` exited {code}: {out.getvalue()[-2000:]}")
        return out.getvalue()

    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_cli_") as tmp:
        root = Path(tmp)
        files = _write_fast_corpus(root / "dataset", actors=CLI_ACTORS, clips=1, seconds=3.0, sample_rate=48000)
        for path in (root / "dataset").rglob("*.wav"):
            if path not in files:  # the corrupt headers: their retry sleeps are not the command line's cost
                path.unlink()
        clip = root / "clip_45s.wav"
        _write_clip(clip, CLI_FILE_SECONDS, 48000, seed=60)
        os.environ.pop("SER_TRAINING_REPAIR_ALLOW_NETWORK", None)
        os.environ.pop("SER_TORCH_DEVICE", None)
        os.environ.update(_cli_environment(root))
        api.infer = recorded_infer
        try:
            # 1-2. Consents and the data subcommands.
            run("configure", ["configure", "--accept-dataset-license", "cc-by-nc-sa-4.0", "--persist"])
            consents = run("consents", ["data", "consents"])
            prepared = run("prepare", ["data", "prepare", "ravdess", "--dataset-root", str(root / "dataset"),
                                       "--skip-download"])
            entries = json.loads(run("registry", ["data", "registry", "--show", "--format", "json"]))["entries"]
            health = run("health", ["data", "health"])
            catalog = json.loads(run("catalog", ["data", "catalog", "--format", "json"]))
            audit = run("audit", ["data", "audit", "--lenient"])
            manifest = read_manifest_jsonl(Path(entries[0]["manifest_path"]))
            say("cli-data", consents=json.dumps(consents.splitlines()), prepared=json.dumps(prepared.strip()),
                registry=json.dumps([(e["dataset_id"], e["utterance_count"]) for e in entries]),
                manifest_rows=len(manifest), health=json.dumps(health.strip()),
                catalog_installed=json.dumps([e["dataset_id"] for e in catalog["entries"] if e["installed"]]),
                audit=json.dumps(audit.splitlines()[0]))
            if "cc-by-nc-sa-4.0" not in consents or [(e["dataset_id"], e["utterance_count"]) for e in entries] != [
                    ("ravdess", len(files))] or len(manifest) != len(files) or "Registry healthy." not in health:
                raise AssertionError(f"the data subcommands: {consents!r}, {entries}, {len(manifest)} rows, {health!r}")

            # 3. Training: readiness alone, then the head (the smoke's encodes and one window a clip).
            dry = run("train-dry-run", ["--train", "--profile", "accurate", "--dry-run"])
            run("train", ["--train", "--profile", "accurate"])
            smoke = min(16, len(files))
            expected_train = {"stft_power_mel_log": smoke + len(files), "flash_attention_fwd": 32 * (smoke + len(files))}
            say("cli-train", dry_run=json.dumps(dry.strip().splitlines()[-1]), clips=len(files), smoke_probes=smoke,
                launches=json.dumps(steps["train"]["launches"]), predicted=json.dumps(expected_train),
                artifacts=json.dumps(sorted(p.name for p in (root / "models").glob("*.pkl"))))
            if steps["train-dry-run"]["launches"] or steps["train"]["launches"] != expected_train:
                raise AssertionError(f"training launched {steps['train']['launches']} (dry run "
                                     f"{steps['train-dry-run']['launches']}), predicted {expected_train}")

            # 4. --file with the trained head, cold, then warm with the timeline's CSV and SRT subtitles.
            request = ["--file", str(clip), "--profile", "accurate", "--no-transcript"]
            timeline = run("file-cold", request)
            subtitles = root / "clip_45s.srt"
            exported = run("file-warm", request + ["--save_transcript", "--subtitle-output", str(subtitles)])
            for execution in executions:
                _check_segments(execution, clip, CLI_FILE_SECONDS, "jax_whisper_encoder")
            expected_file = {"stft_power_mel_log": 1, "flash_attention_fwd": 32}
            csv_line = next(line for line in exported.splitlines() if line.startswith("Timeline CSV: "))
            srt = subtitles.read_text(encoding="utf-8")
            say("cli-file", clip=clip.name, segments=len(executions[0].detailed_result.segments),
                cold_s=steps["file-cold"]["seconds"], warm_s=steps["file-warm"]["seconds"],
                infer_phase_warm_45s_s=INFER_45S_WARM_S, launches=json.dumps(steps["file-cold"]["launches"]),
                predicted=json.dumps(expected_file), csv=json.dumps(csv_line), srt_cues=srt.count(" --> "),
                srt_bytes=len(srt.encode()))
            if len(executions) != 2 or any(steps[s]["launches"] != expected_file for s in ("file-cold", "file-warm")):
                raise AssertionError(f"--file launched {steps['file-cold']['launches']} and "
                                     f"{steps['file-warm']['launches']}, predicted {expected_file} each")
            if not Path(csv_line.removeprefix("Timeline CSV: ")).is_file() or f"Subtitles: {subtitles}" not in exported \
                    or srt.count(" --> ") != sum(1 for entry in executions[1].timeline if entry.speech.strip()) \
                    or not exported.startswith(timeline):
                raise AssertionError(f"the exports of --file, or its timeline: {exported[-600:]!r}")

            # 6. The repair (network repairs off) and the doctor.
            repaired = run("train-repair", ["--train", "--profile", "accurate", "--repair"])
            doctor = json.loads(run("doctor", ["doctor", "--format", "json", "--profile", "accurate"]))
            card = torch.cuda.get_device_name(0)
            accelerator = next(f for f in doctor["findings"] if f["code"] == "accelerator")
            say("cli-repair-doctor", repair=json.dumps(repaired.strip().splitlines()[-1]),
                network_repair=json.dumps(next(line for line in repaired.splitlines() if "redownload" in line)),
                doctor_codes=json.dumps([f"{f['code']}:{f['severity']}" for f in doctor["findings"]]),
                accelerator=json.dumps(accelerator["message"]))
            expected_repair = {"stft_power_mel_log": smoke, "flash_attention_fwd": 32 * smoke}
            if steps["train-repair"]["launches"] != expected_repair or steps["doctor"]["launches"]:
                raise AssertionError(f"the repair's smoke launched {steps['train-repair']['launches']}, predicted "
                                     f"{expected_repair}; the doctor {steps['doctor']['launches']}")
            if f"usable={len(files)} quarantined=0 blocking=False" not in repaired or "repair[FAILED] " \
                    "redownload_pinned_model" not in repaired or card not in accelerator["message"] or any(
                        f["blocking"] for f in doctor["findings"]):
                raise AssertionError(f"repair {repaired[-800:]!r}; doctor {doctor}")
        finally:
            api.infer = infer
            env_for_subprocess = dict(os.environ)
            os.environ.clear()
            os.environ.update(saved_env)

        # 7. The module entry point in its own process, on the card.
        env_for_subprocess["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + ([saved_env["PYTHONPATH"]] if saved_env.get("PYTHONPATH") else []))
        started = time.perf_counter()
        completed = subprocess.run([sys.executable, "-m", "ser_tpu_torch", *request], cwd=REPO,
                                   env=env_for_subprocess, capture_output=True, text=True, timeout=180)
        subprocess_s = time.perf_counter() - started
        rows = completed.stdout.strip().splitlines()
        say("cli-subprocess", exit_code=completed.returncode, seconds=f"{subprocess_s:.3f}", timeline_rows=len(rows) - 1,
            same_timeline_as_in_process=rows == timeline.strip().splitlines())
        if completed.returncode != 0 or len(rows) < 2 or "Emotion" not in rows[0]:
            raise AssertionError(f"python -m ser_tpu_torch exited {completed.returncode}: "
                                 f"{completed.stdout[-1000:]} {completed.stderr[-2000:]}")
    wall_s = time.perf_counter() - phase_started
    say("cli-wall", wall_s=f"{wall_s:.1f}", limit_s=CLI_WALL_LIMIT_S,
        steps_s=json.dumps({step: reading["seconds"] for step, reading in steps.items()}),
        subprocess_s=f"{subprocess_s:.3f}")
    if wall_s > CLI_WALL_LIMIT_S:
        raise AssertionError(f"the cli phase took {wall_s:.1f} s, over its {CLI_WALL_LIMIT_S} s")
    launches = {counter.name: sum(reading["launches"].get(counter.name, 0) for reading in steps.values())
                for counter in counters}
    return {"launches": launches, "steps": steps, "wall_s": wall_s, "subprocess_s": subprocess_s}


#: Phase transcript-infer: one clip of at most 30 s (one window), the staged decoder's phrase repeated so
#: that the window is repetitive (gzip ratio above 2.4) and every request runs the whole retry ladder.
TRANSCRIPT_INFER_CLIP_SECONDS = 20.0
TRANSCRIPT_PHRASE_REPEATS = 4
#: Norm of the staged decoder's position rows that spell the phrase: far above the layers' outputs (about
#: 300 after 32 random layers), so each step's logits single out the row's token.
TRANSCRIPT_POSITION_NORM = 3.0e4
#: The spelled tokens' embeddings are this many times the others' (std 0.02): their logits then beat the
#: summed probability of the 1501 timestamps, which would otherwise force a timestamp.
TRANSCRIPT_TARGET_EMBED_SCALE = 10.0
TRANSCRIPT_INFER_WALL_LIMIT_S = 180.0
#: Ten (layer, head) pairs of large-v3's decoder, as ``generation_config.json`` carries them.
STAGED_ALIGNMENT_HEADS = [[7, 0], [10, 17], [12, 18], [13, 12], [16, 1], [17, 14], [19, 11], [21, 4], [24, 1],
                          [25, 6]]
#: A fixed suppress list in the file's form: punctuation-like ids and the task tokens.
STAGED_SUPPRESS_TOKENS = [1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63, 90, 91, 92, 93,
                          359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350, 1853, 1982, 2460, 2627, 3246,
                          3253, 3268, 3536, 3846, 3961, 4183, 4667, 6585, 6647, 7273, 9061, 9383, 10428, 10929,
                          11938, 12033, 12331, 12562, 13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362,
                          18956, 20075, 21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
                          36865, 42863, 47425, 49870, 50254, 50258, 50359, 50360, 50361, 50362, 50363]


def _write_safetensors_f16(path: Path, tensors: list) -> int:
    """``tensors`` as (name, shape, make) written in order as F16: the 8-byte header length, the JSON header
    padded to 8 bytes, then each ``make()`` (a CUDA tensor, drawn as it is written). Returns the file's bytes."""
    import torch

    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, shape, _ in tensors:
        size = 2 * math.prod(shape)
        header[name] = {"dtype": "F16", "shape": list(shape), "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with path.open("wb") as handle:
        handle.write(struct.pack("<Q", len(raw)))
        handle.write(raw)
        for name, shape, make in tensors:
            tensor = make()
            if tuple(tensor.shape) != tuple(shape):
                raise AssertionError(f"{name}: drew {tuple(tensor.shape)}, declared {shape}")
            handle.write(tensor.to(torch.float16).cpu().numpy().tobytes())
    return 8 + len(raw) + offset


def _stage_large_v3_checkpoint(model_dir: Path, *, seed: int = 0) -> dict:
    """A seeded large-v3 checkpoint as Hugging Face publishes one, at its full widths.

    ``model.safetensors`` in F16 (``model.``-prefixed names, no ``proj_out``: the output head is tied),
    ``config.json``, ``generation_config.json`` with ``alignment_heads`` and ``suppress_tokens``, and the
    tokenizer files of ``write_whisper_tokenizer_files``. Kernels have std 1/sqrt(fan-in), biases 0,
    LayerNorms 1 and 0, token embeddings std 0.02 (``TRANSCRIPT_TARGET_EMBED_SCALE`` times that for the
    tokens spelled here). The decoder's position rows 2 onward point along the embeddings of a fixed token
    sequence (norm ``TRANSCRIPT_POSITION_NORM``): <|0.00|>, a phrase (six
    ``Ġ`` words, then " é" as three byte tokens that split the character) ``TRANSCRIPT_PHRASE_REPEATS``
    times, <|10.00|>, <|endoftext|>. Every greedy or sampled decode then emits that sequence whatever the
    audio, and ends; the repeated phrase makes the window repetitive, so the retry ladder runs in full.
    """
    import torch

    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models.whisper_tokenizer import bytes_to_unicode

    config = wm.WhisperConfig()
    d, ffn, n_mels = config.d_model, 4 * config.d_model, config.n_mels
    vocab = write_whisper_tokenizer_files(model_dir, seed=seed)
    n_vocab = len(vocab)
    suppressed = set(STAGED_SUPPRESS_TOKENS)
    words = [index for token, index in vocab.items()
             if token.startswith("Ġ") and token[1:].isascii() and token[1:].isalpha() and len(token) >= 4
             and index not in suppressed][:6]
    byte_encoder = bytes_to_unicode()
    phrase = words + [vocab[byte_encoder[byte]] for byte in " é".encode("utf-8")]
    eot, timestamp_begin = n_vocab, n_vocab + len(whisper_added_tokens(n_vocab)) - 1501
    targets = [timestamp_begin] + phrase * TRANSCRIPT_PHRASE_REPEATS + [timestamp_begin + 500, eot]

    cuda = torch.device("cuda")
    generator = torch.Generator(device=cuda).manual_seed(seed)

    def normal(shape, std):
        return lambda: torch.randn(shape, generator=generator, device=cuda) * std

    def const(shape, value):
        return lambda: torch.full(shape, value, device=cuda)

    embed = normal((config.vocab_size, d), 0.02)()
    positions = normal((config.max_target_positions, d), 0.01)()
    spelled = torch.as_tensor(targets, device=cuda)
    embed[spelled.unique()] *= TRANSCRIPT_TARGET_EMBED_SCALE
    rows = embed[spelled]
    positions[2 : 2 + len(targets)] = rows / rows.norm(dim=1, keepdim=True) * TRANSCRIPT_POSITION_NORM
    tensors: list = []

    def dense(name, out_dim, in_dim, bias=True):
        tensors.append((f"{name}.weight", (out_dim, in_dim), normal((out_dim, in_dim), in_dim ** -0.5)))
        if bias:
            tensors.append((f"{name}.bias", (out_dim,), const((out_dim,), 0.0)))

    def norm(name):
        tensors.append((f"{name}.weight", (d,), const((d,), 1.0)))
        tensors.append((f"{name}.bias", (d,), const((d,), 0.0)))

    def attention(name):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{name}.{proj}", d, d, bias=proj != "k_proj")

    def block(base, cross):
        attention(f"{base}.self_attn")
        norm(f"{base}.self_attn_layer_norm")
        if cross:
            attention(f"{base}.encoder_attn")
            norm(f"{base}.encoder_attn_layer_norm")
        dense(f"{base}.fc1", ffn, d)
        dense(f"{base}.fc2", d, ffn)
        norm(f"{base}.final_layer_norm")

    tensors.append(("model.encoder.conv1.weight", (d, n_mels, 3), normal((d, n_mels, 3), (3 * n_mels) ** -0.5)))
    tensors.append(("model.encoder.conv1.bias", (d,), const((d,), 0.0)))
    tensors.append(("model.encoder.conv2.weight", (d, d, 3), normal((d, d, 3), (3 * d) ** -0.5)))
    tensors.append(("model.encoder.conv2.bias", (d,), const((d,), 0.0)))
    sinusoids = torch.from_numpy(wm._sinusoids(wm.CHUNK_FRAMES // 2, d))
    tensors.append(("model.encoder.embed_positions.weight", tuple(sinusoids.shape), lambda: sinusoids.to(cuda)))
    for index in range(config.encoder_layers):
        block(f"model.encoder.layers.{index}", cross=False)
    norm("model.encoder.layer_norm")
    tensors.append(("model.decoder.embed_tokens.weight", tuple(embed.shape), lambda: embed))
    tensors.append(("model.decoder.embed_positions.weight", tuple(positions.shape), lambda: positions))
    for index in range(config.decoder_layers):
        block(f"model.decoder.layers.{index}", cross=True)
    norm("model.decoder.layer_norm")
    size = _write_safetensors_f16(model_dir / "model.safetensors", tensors)
    (model_dir / "config.json").write_text(json.dumps({
        "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper", "torch_dtype": "float16",
        "num_mel_bins": n_mels, "d_model": d, "encoder_layers": config.encoder_layers,
        "decoder_layers": config.decoder_layers, "encoder_attention_heads": config.n_heads,
        "decoder_attention_heads": config.n_heads, "encoder_ffn_dim": ffn, "decoder_ffn_dim": ffn,
        "vocab_size": config.vocab_size, "max_source_positions": wm.CHUNK_FRAMES // 2,
        "max_target_positions": config.max_target_positions,
    }))
    (model_dir / "generation_config.json").write_text(json.dumps({
        "alignment_heads": STAGED_ALIGNMENT_HEADS, "suppress_tokens": STAGED_SUPPRESS_TOKENS,
        "begin_suppress_tokens": [220, eot], "decoder_start_token_id": eot + 1, "eos_token_id": eot,
        "no_timestamps_token_id": timestamp_begin - 1, "is_multilingual": True,
    }))
    del embed, positions, rows
    return {"phrase": phrase, "targets": targets, "bytes": size, "tensors": len(tensors)}


def _link_checkpoint(source: Path, target: Path) -> None:
    """The emotion lane's copy of the staged checkpoint: hard links, so the weights are on the disk once."""
    target.mkdir(parents=True)
    for path in source.iterdir():
        os.link(path, target / path.name)


def phase_transcript_infer() -> dict:
    """The default request, transcript on, through the entry points a user calls, on a staged full-width F16
    large-v3 checkpoint read by the port's loader and tokenizer (no ``transformers``), with the card's
    default settings: ``api.infer`` cold and warm, the CLI's ``--file`` in this process and in a subprocess,
    a request with htdemucs before the transcript, ``doctor`` and ``--calibrate-transcription-runtime``."""
    import csv
    import io

    import numpy as np
    import torch

    import ser_tpu_torch.__main__ as cli
    import ser_tpu_torch.api as api
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.transcript import extractor
    from ser_tpu_torch._internal.utils import source_separation
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file, resample_audio
    from ser_tpu_torch.config import reload_settings
    from ser_tpu_torch.models import attention
    from ser_tpu_torch.models import demucs_v4 as tdm
    from ser_tpu_torch.models import whisper as wm
    from ser_tpu_torch.models.whisper_tokenizer import WhisperTokenizer
    from ser_tpu_torch.ops import decode_step_kernels as dsk
    from ser_tpu_torch.ops import log_mel

    phase_started = time.perf_counter()
    card = nvidia_smi_line()
    counters = (log_mel.FUSED_COUNTER, log_mel.COUNTER, attention.COUNTER, attention.F32_COUNTER,
                attention.BWD_COUNTER, *dsk.COUNTERS)
    scratch_root = REPO / "build"
    scratch_root.mkdir(exist_ok=True)
    saved_env = dict(os.environ)
    requests: dict[str, dict] = {}
    decodes: list[dict] = []
    admissions: list = []
    separations: list = []
    executions: list = []
    transcribed: list[tuple] = []
    infer, decode_batch = api.infer, wm.WhisperForTranscription._decode_chunk_batch
    transcribe_words = wm.WhisperForTranscription.transcribe_words
    admit, separate = extractor.admit_transcription_model, source_separation.separate_vocals_auto

    def recorded_infer(*args, **kwargs):
        executions.append(infer(*args, **kwargs))
        return executions[-1]

    def recorded_decode(self, states, language, num_frames, *, temperature=0.0, rng_seed=0):
        emitted, matrix = decode_batch(self, states, language, num_frames, temperature=temperature,
                                       rng_seed=rng_seed)
        decodes.append({"rows": len(emitted), "temperature": temperature,
                        "tokens": [[int(token) for token in row] for row in emitted]})
        return emitted, matrix

    def recorded_transcribe_words(self, audio16k, **kwargs):
        transcribed.append((audio16k, kwargs))
        return transcribe_words(self, audio16k, **kwargs)

    def recorded_admit(*args, **kwargs):
        admissions.append(admit(*args, **kwargs))
        return admissions[-1]

    def recorded_separate(*args, **kwargs):
        separations.append(kwargs.get("model_path"))
        return separate(*args, **kwargs)

    def request(name: str, fn):
        """One request: wall seconds, the kernels' launches, the decodes, peak memory; the pipeline's phase
        timings of the request's last ``api.infer``."""
        for counter in counters:
            counter.launches = 0
        decodes.clear()
        separations.clear()
        executions_before = len(executions)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # api.infer prints the timeline table
            result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - started
        launches = {counter.name: counter.launches for counter in counters if counter.launches}
        timings = executions[-1].phase_timings_seconds if len(executions) > executions_before else {}
        reading = {"seconds": seconds, "launches": launches, "decodes": [dict(entry) for entry in decodes],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "phase_timings_s": dict(timings),
                   "separations": list(separations)}
        requests[name] = reading
        say("transcript-infer-request", request=name, wall_s=f"{seconds:.4f}",
            phase_timings_s=json.dumps({key: round(value, 4) for key, value in timings.items()}),
            decodes_per_window=json.dumps([(entry["rows"], entry["temperature"], [len(t) for t in entry["tokens"]])
                                           for entry in decodes]),
            launches=json.dumps(launches), peak_gib=f"{reading['peak_gib']:.2f}",
            separator=json.dumps([str(path) if path else "REPET-SIM" for path in separations]), card=json.dumps(card))
        return result

    def run_cli(argv: list[str]) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
        if code != 0:
            raise AssertionError(f"`{' '.join(argv)}` exited {code}: {out.getvalue()[-2000:]}")
        return out.getvalue()

    with tempfile.TemporaryDirectory(dir=scratch_root, prefix="chip_smoke_transcript_") as tmp:
        root = Path(tmp)
        # Staging: the checkpoint under the transcript lane's root, hard-linked under the emotion lane's.
        started = time.perf_counter()
        transcript_dir = root / "cache" / "model-cache" / "OpenAI" / "whisper" / "large"
        staged = _stage_large_v3_checkpoint(transcript_dir)
        _link_checkpoint(transcript_dir, root / "cache" / "model-cache" / "huggingface" / "openai" /
                         "whisper-large-v3")
        stage_s = time.perf_counter() - started
        config = tdm.DemucsV4Config()
        demucs_path = root / "htdemucs.npz"
        tdm.save_demucs_npz(tdm.init_demucs_params(config, seed=0), demucs_path, config=config)
        _write_head_envelope(root / "models" / profile_artifact_file_name(
            profile="accurate", model_id="openai/whisper-large-v3"), feature_size=2 * 1280)
        clip = root / "clip_20s.wav"
        _write_clip(clip, TRANSCRIPT_INFER_CLIP_SECONDS, 48000, seed=70)
        corpus = root / "dataset" / "Actor_01" / "03-01-01-01-01-01-01.wav"
        corpus.parent.mkdir(parents=True)
        _write_clip(corpus, 3.0, 48000, seed=71)
        tokenizer = WhisperTokenizer.from_pretrained(transcript_dir)
        say("transcript-infer-stage", safetensors_gib=f"{staged['bytes'] / 2**30:.3f}", dtype="F16",
            tensors=staged["tensors"], seconds=f"{stage_s:.2f}", phrase=json.dumps(tokenizer.decode(staged["phrase"])),
            phrase_ids=json.dumps(staged["phrase"]), demucs_npz_mb=f"{demucs_path.stat().st_size / 1e6:.1f}")

        for name in ("SER_ALLOW_RANDOM_INIT", "SER_RANDOM_INIT_SIZE", "SER_TORCH_DEVICE", "SER_TORCH_DTYPE",
                     "SER_DECODE_INT8", "SER_SEPARATION_MODEL_PATH", "WHISPER_DEMUCS"):
            os.environ.pop(name, None)
        os.environ.update(_cli_environment(root))
        for name in ("SER_ALLOW_RANDOM_INIT", "SER_RANDOM_INIT_SIZE"):
            os.environ.pop(name, None)
        free_before = torch.cuda.mem_get_info()[0] / 2**20
        torch.cuda.empty_cache()
        say("transcript-infer-memory", free_mib_before_empty_cache=f"{free_before:.0f}",
            free_mib=f"{torch.cuda.mem_get_info()[0] / 2**20:.0f}")
        api.infer = recorded_infer
        wm.WhisperForTranscription._decode_chunk_batch = recorded_decode
        wm.WhisperForTranscription.transcribe_words = recorded_transcribe_words
        extractor.admit_transcription_model = recorded_admit
        source_separation.separate_vocals_auto = recorded_separate
        try:
            reload_settings()
            # (a) api.infer with its defaults: the transcript on. Cold, then warm.
            cold = request("infer-cold", lambda: api.infer(clip, profile="accurate"))
            warm = request("infer-warm", lambda: api.infer(clip, profile="accurate"))
            off = request("infer-no-transcript", lambda: api.infer(clip, profile="accurate",
                                                                   include_transcript=False))
            # The same words from a model that from_pretrained_dir loads with its defaults (the card, bf16), fed
            # the audio the cold request's model was fed (the profile's separation and spectral gate done). This
            # holds the request's plumbing to a direct call on the same kernels; K3-K5 at this decode's one row
            # are held to their plain versions in phases K3, K4 and K5.
            request_audio, request_options = transcribed[0]
            audio, rate = read_audio_file(str(clip))
            direct_model = request("from-pretrained-dir", lambda: wm.WhisperForTranscription.from_pretrained_dir(
                transcript_dir))
            direct = request("transcribe-words", lambda: direct_model.transcribe_words(
                request_audio, **request_options))
            direct_device = (str(direct_model.device), str(direct_model.compute_dtype))
            del direct_model
            # (b) The CLI's --file in this process, transcript on, with the timeline's CSV and SRT.
            subtitles = root / "clip_20s.srt"
            argv = ["--file", str(clip), "--profile", "accurate", "--save_transcript", "--subtitle-output",
                    str(subtitles)]
            printed = request("cli-file", lambda: run_cli(argv))
            cli_execution = executions[-1]
            srt = subtitles.read_text(encoding="utf-8")
            csv_path = Path(next(line for line in printed.splitlines() if line.startswith("Timeline CSV: "))
                            .removeprefix("Timeline CSV: "))
            with csv_path.open(encoding="utf-8") as handle:
                csv_rows = list(csv.DictReader(handle))
            # (d) htdemucs before the transcript, through settings.
            os.environ.update({"WHISPER_DEMUCS": "1", "SER_SEPARATION_MODEL_PATH": str(demucs_path)})
            reload_settings()
            separated = request("infer-separated", lambda: api.infer(clip, profile="accurate"))
            for name in ("WHISPER_DEMUCS", "SER_SEPARATION_MODEL_PATH"):
                os.environ.pop(name)
            reload_settings()
            # (e) doctor with its transcription checks; (f) the calibration on one RAVDESS-named clip.
            doctor = json.loads(request("doctor", lambda: run_cli(["doctor", "--format", "json", "--profile",
                                                                   "accurate"])))
            calibrated = request("calibrate", lambda: run_cli([
                "--calibrate-transcription-runtime", "--calibration-profiles", "accurate",
                "--calibration-iterations", "1"]))
        finally:
            api.infer = infer
            wm.WhisperForTranscription._decode_chunk_batch = decode_batch
            wm.WhisperForTranscription.transcribe_words = transcribe_words
            extractor.admit_transcription_model = admit
            source_separation.separate_vocals_auto = separate
            env_for_subprocess = dict(os.environ)
            os.environ.clear()
            os.environ.update(saved_env)
            reload_settings()

        # (c) The same --file request through python -m ser_tpu_torch in its own process.
        env_for_subprocess["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + ([saved_env["PYTHONPATH"]] if saved_env.get("PYTHONPATH") else []))
        started = time.perf_counter()
        completed = subprocess.run([sys.executable, "-m", "ser_tpu_torch", *argv], cwd=REPO,
                                   env=env_for_subprocess, capture_output=True, text=True, timeout=300)
        subprocess_s = time.perf_counter() - started
        say("transcript-infer-request", request="cli-subprocess", wall_s=f"{subprocess_s:.4f}",
            exit_code=completed.returncode, card=json.dumps(card))
        if completed.returncode != 0:
            raise AssertionError(f"python -m ser_tpu_torch exited {completed.returncode}: "
                                 f"{completed.stdout[-1000:]} {completed.stderr[-3000:]}")
        subprocess_srt = subtitles.read_text(encoding="utf-8")

    # Checks.
    expected_words = tokenizer.decode(staged["phrase"] * TRANSCRIPT_PHRASE_REPEATS).split()
    runs = {"infer-cold": cold.transcript, "infer-warm": warm.transcript, "transcribe-words": direct,
            "cli-file": cli_execution.transcript, "infer-separated": separated.transcript}
    words = {name: [w.word.strip() for w in transcript] for name, transcript in runs.items()}
    say("transcript-infer-words", count=len(words["infer-cold"]), first=json.dumps(words["infer-cold"][:9]),
        expected_count=len(expected_words), direct_device=json.dumps(direct_device),
        same_as_direct=[(w.word, w.start_seconds, w.end_seconds) for w in cold.transcript]
        == [(w.word, w.start_seconds, w.end_seconds) for w in direct],
        request_options=json.dumps(request_options), request_audio_is_the_clip=bool(
            request_audio.shape == resample_audio(audio, rate, 16000).shape
            and np.array_equal(request_audio, resample_audio(audio, rate, 16000))),
        admissions=json.dumps([decision.reason for decision in admissions]))
    for name, listed in words.items():
        if listed != expected_words:
            raise AssertionError(f"{name}: words {listed[:12]}..., expected the staged phrase {expected_words[:9]}")
    for name in ("infer-cold", "infer-warm", "cli-file", "infer-separated", "calibrate"):
        reading = requests[name]
        window_text = {tokenizer.decode([t for t in tokens if t < staged["targets"][0]])
                       for entry in reading["decodes"] for tokens in entry["tokens"]}
        if name != "calibrate" and any(all(word not in text for text in window_text) for word in words.get(
                name, [])):
            raise AssertionError(f"{name}: a word is not in its window's decode")
        steps = sum(3 + max(len(tokens) for tokens in entry["tokens"]) for entry in reading["decodes"])
        launches = reading["launches"]
        k3, k4, k5 = (launches.get(kernel, 0) for kernel in ("ln_qkv_project", "self_attend_and_out",
                                                             "cross_attention_step"))
        if not (k3 == k4 == k5 == 32 * steps > 0) or launches.get("stft_power_mel_log", 0) < 1 \
                or launches.get("flash_attention_fwd", 0) < 32:
            raise AssertionError(f"{name}: launches {launches}, predicted K3 = K4 = K5 = 32 x {steps} steps")
        if len(reading["decodes"]) % (1 + len(wm.WhisperForTranscription.RETRY_TEMPERATURES)):
            raise AssertionError(f"{name}: {len(reading['decodes'])} decodes, not the whole retry ladder")
    if [tuple(s) for s in cold.emotions] != [tuple(s) for s in off.emotions] or \
            [tuple(s) for s in warm.emotions] != [tuple(s) for s in off.emotions]:
        raise AssertionError("the emotion segments with the transcript on differ from those without it")
    _check_segments(off, clip, TRANSCRIPT_INFER_CLIP_SECONDS, "jax_whisper_encoder")
    if [(w.word, w.start_seconds, w.end_seconds) for w in cold.transcript] != \
            [(w.word, w.start_seconds, w.end_seconds) for w in direct]:
        raise AssertionError("api.infer's words and times differ from transcribe_words on the loaded model")
    if direct_device != ("cuda", "torch.bfloat16"):
        raise AssertionError(f"from_pretrained_dir's defaults gave {direct_device}, not the card in bf16")
    speech_rows = [row for row in csv_rows if any(value.strip() for key, value in row.items()
                                                  if key and "speech" in key.lower())]
    say("transcript-infer-export", csv=csv_path.name, csv_rows=len(csv_rows), csv_speech_rows=len(speech_rows),
        srt_cues=srt.count(" --> "), srt_same_in_subprocess=srt == subprocess_srt,
        timeline_speech_entries=sum(1 for entry in cli_execution.timeline if entry.speech.strip()))
    if not speech_rows or srt.count(" --> ") != sum(1 for entry in cli_execution.timeline if entry.speech.strip()) \
            or srt != subprocess_srt or "Timeline CSV: " not in completed.stdout:
        raise AssertionError(f"the exports: {len(speech_rows)} speech rows, SRT {srt[:300]!r}, subprocess "
                             f"{completed.stdout[-600:]!r}")
    if requests["infer-separated"]["separations"] != [demucs_path]:
        raise AssertionError(f"the separated request did not run htdemucs: {requests['infer-separated']}")
    if not admissions or not all(decision.admitted for decision in admissions):
        raise AssertionError(f"device-memory admission: {[decision.reason for decision in admissions]}")
    assets = next(f for f in doctor["findings"] if f["code"] == "transcription.assets")
    say("transcript-infer-doctor", codes=json.dumps([f"{f['code']}:{f['severity']}" for f in doctor["findings"]]),
        assets=json.dumps(assets["message"]), calibrated=json.dumps(calibrated.strip().splitlines()[-1]))
    if any(f["blocking"] for f in doctor["findings"]) or assets["severity"] != "info" \
            or "Recommended: large" not in calibrated or "1 samples" not in calibrated:
        raise AssertionError(f"doctor {doctor}; calibration {calibrated!r}")
    wall_s = time.perf_counter() - phase_started
    say("transcript-infer-wall", wall_s=f"{wall_s:.1f}", limit_s=TRANSCRIPT_INFER_WALL_LIMIT_S,
        stage_s=f"{stage_s:.2f}", subprocess_s=f"{subprocess_s:.3f}",
        requests_s=json.dumps({name: round(reading["seconds"], 3) for name, reading in requests.items()}))
    if wall_s > TRANSCRIPT_INFER_WALL_LIMIT_S:
        raise AssertionError(f"the transcript-infer phase took {wall_s:.1f} s, over its "
                             f"{TRANSCRIPT_INFER_WALL_LIMIT_S} s")
    main_path = ("infer-cold", "infer-warm", "cli-file", "infer-separated")
    launches = {counter.name: sum(requests[name]["launches"].get(counter.name, 0) for name in main_path)
                for counter in counters}
    return {"launches": launches, "requests": requests, "wall_s": wall_s, "subprocess_s": subprocess_s}


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


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

    run_started = time.perf_counter()
    marks: list[tuple[str, float]] = []

    def mark(name: str) -> str:
        marks.append((name, time.perf_counter()))
        return name

    def say_phase_walls() -> None:
        ends = [started for _, started in marks[1:]] + [time.perf_counter()]
        say("phase-walls", seconds=json.dumps({name: round(end - started, 1)
                                               for (name, started), end in zip(marks, ends)}))

    phase = mark("env")
    try:
        env = phase_environment()
        phase = mark("K1")
        k1 = phase_k1()
        phase = mark("resample")
        resample_kernel = phase_resample()
        phase = mark("K2")
        k2 = phase_k2()
        phase = mark("K2-f32")
        k2_f32 = phase_k2_f32()
        phase = mark("K2-medium")
        k2_medium = phase_k2_medium()
        phase = mark("K2-bwd")
        k2_bwd = phase_k2_bwd()
        phase = mark("K3")
        k3 = phase_k3()
        phase = mark("K4")
        k4 = phase_k4()
        phase = mark("K5")
        k5 = phase_k5()
        phase = mark("grad-guard")
        phase_grad_guard()
        phase = mark("encoder")
        per_encode = phase_encoder()
        phase = mark("decode")
        decode = phase_decode()
        phase = mark("transcribe")
        transcribe = phase_transcribe()
        phase = mark("infer")
        launches = phase_infer()
        phase = mark("train")
        train = phase_train()
        phase = mark("medium-encoder")
        medium_encode = phase_medium_encoder()
        phase = mark("medium-infer")
        medium = phase_medium_infer()
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_research_") as staging:
            phase = mark("research-encoder")
            research_encode = phase_research_encoder(Path(staging) / "cache")
            phase = mark("research-infer")
            research = phase_research_infer(Path(staging) / "cache")
        phase = mark("fast-infer")
        phase_fast_infer()
        phase = mark("beam")
        beam = phase_beam()
        phase = mark("int8-decode")
        int8_decode = phase_int8_decode(decode)
        phase = mark("int8-encoder")
        int8_encoder = phase_int8_encoder()
        phase = mark("k2-remeasure")
        k2_remeasure = phase_k2_remeasure()
        phase = mark("boundary")
        boundary = phase_boundary()
        phase = mark("fast-train")
        started = time.perf_counter()
        phase_fast_train()
        say("fast-train-wall", wall_s=f"{time.perf_counter() - started:.1f}")
        phase = mark("accurate-train")
        accurate_train = phase_accurate_train()
        phase = mark("medium-train")
        medium_train = phase_medium_train()
        phase = mark("research-train")
        research_train = phase_research_train()
        phase = mark("dist-train")
        dist_train = phase_dist_train(train)
        phase = mark("batch-infer")
        batch_infer = phase_batch_infer()
        phase = mark("separate")
        separate = phase_separate()
        phase = mark("cli")
        cli = phase_cli()
        phase = mark("transcript-infer")
        transcript_infer = phase_transcript_infer()
        phase = mark("device-defaults")
        device_defaults = phase_device_defaults()
        phase = mark("operator")
        operator = phase_operator()
    except Exception:
        traceback.print_exc()
        say_phase_walls()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    finally:
        from ser_tpu_torch.parallel.distributed import shutdown_distributed

        shutdown_distributed()
    say_phase_walls()

    # K1 (both forms) and K2: launches of the three api.infer requests; K3-K5: of the first
    # (full-budget) transcribe_words call. Each path's counts are set to 0 just
    # before it and read just after.
    k1["fused"].update(launches=launches["stft_power_mel_log"], launches_per_encode=per_encode["k1_per_encode"])
    resample_kernel.update(launches=launches["resample_rows"], launches_per_encode=1)
    k1["spectrum"].update(launches=launches["power_mel_log"],
                          launches_per_encode=per_encode["k1_spectrum_form_per_encode"])
    k2.update(launches=launches["flash_attention_fwd"], launches_per_encode=per_encode["k2_per_encode"],
              medium_launches=medium["bf16_requests"]["flash_attention_fwd"],
              medium_launches_per_encode=medium_encode["k2_per_encode"],
              medium_masked_ms=k2_medium["30s"]["masked_ms"], medium_unmasked_ms=k2_medium["30s"]["unmasked_ms"],
              medium_15s_masked_ms=k2_medium["15s"]["masked_ms"], medium_rel_l2_err=k2_medium["30s"]["rel_l2_err"],
              research_launches=research["bf16_requests"]["flash_attention_fwd"],
              research_launches_per_encode=research_encode["k2_per_encode"])
    # K2-f32: launches of the medium-infer path (its float32 request and its retry);
    # research_*: K2's of research-infer's three bf16 requests, K2-f32's of its retry.
    k2_f32.update(launches=medium["total"]["flash_attention_f32"],
                  launches_per_float32_encode=medium["per_float32_encode"],
                  launches_per_float32_request=medium["float32_request"],
                  launches_per_retry_request=medium["retry_request"],
                  research_retry_launches=research["retry_request"],
                  research_launches_per_float32_encode=research["per_float32_encode"])
    for kernel in (k3, k4, k5):
        kernel.update(launches=transcribe["launches"][kernel["name"]],
                      launches_per_decode=decode["launches_per_decode"][kernel["name"]],
                      decode_steps=decode["steps"])
    # K2-bwd: launches of the timed train call (3 steps).
    k2_bwd.update(launches=train["launches"]["flash_attention_bwd"],
                  launches_per_step=train["launches_per_step"]["flash_attention_bwd"])
    # The transcript lane's beam route and the int8 lanes: launches of the cold beam
    # and int8 transcripts (one 2-window encode each) and of the three int8 api.infer requests.
    for kernel in (k1["fused"], k1["spectrum"], k2, k3, k4, k5):
        kernel.update(beam_launches=beam["launches"].get(kernel["name"], 0),
                      int8_decode_launches=int8_decode["launches"].get(kernel["name"], 0),
                      int8_infer_launches=int8_encoder["infer_launches"].get(kernel["name"], 0))
    # K2 re-measured against SDPA in turns; K1 and K2: launches of the boundary's
    # transient-error request (two attempts, each one encode).
    k2.update(remeasure_ms=k2_remeasure["k2"]["ms"], remeasure_min_ms=k2_remeasure["k2"]["min_ms"],
              remeasure_max_ms=k2_remeasure["k2"]["max_ms"], remeasure_library_ms=k2_remeasure["sdpa"]["ms"])
    retried = boundary["transient-once"]["launches"]
    for kernel in (k1["fused"], k1["spectrum"], k2):
        kernel.update(boundary_retry_launches=retried.get(kernel["name"], 0))
    # The training entry points: launches of the first accurate, medium and accurate-research api.train
    # runs (the smoke's 16 encodes included) and of the medium run whose planted non-finite encode
    # retried in float32.
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(accurate_train_launches=accurate_train["launches"].get(kernel["name"], 0),
                      medium_train_launches=medium_train["launches"].get(kernel["name"], 0),
                      medium_train_retry_launches=medium_train["retry_launches"].get(kernel["name"], 0),
                      research_train_launches=research_train["launches"].get(kernel["name"], 0))
    # The training encodes' shapes (4 s bucket, batch 32 and 1) against the plain versions, and the pooled
    # training rows through each kernel against the plain attention.
    k2.update(train_shape_rel_l2_err=k2_medium["4s-train"]["rel_l2_err"],
              smoke_shape_rel_l2_err=k2_medium["4s-smoke"]["rel_l2_err"],
              accurate_train_rows_rel_l2_err=accurate_train["row_rel_l2_err"],
              medium_train_rows_rel_l2_err=medium_train["rows_bf16"]["rel_l2_err"],
              research_train_rows_rel_l2_err=research_train["rows"]["rel_l2_err"])
    k2_f32.update(train_shape_max_abs_err=k2_f32["train_shapes"]["4s-train"],
                  smoke_shape_max_abs_err=k2_f32["train_shapes"]["4s-smoke"],
                  medium_train_rows_rel_l2_err=medium_train["rows_f32"]["rel_l2_err"])
    del k2_f32["train_shapes"]
    # The distributed layer: launches of dist-train's compared mesh call (3 steps) and of the first
    # infer_many call of batch-infer (12 clips; masked K2: medium's).
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(dist_train_launches=dist_train["launches"].get(kernel["name"], 0),
                      batch_infer_launches=batch_infer["accurate"]["launches"].get(kernel["name"], 0),
                      batch_infer_medium_launches=batch_infer["medium"]["launches"].get(kernel["name"], 0))
    # Neural separation before the transcript: launches of the cold separated transcribe (htdemucs; the
    # U-Net's apart), one 60 s clip in two windows.
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(separate_launches=separate["launches"].get(kernel["name"], 0),
                      separate_unet_launches=separate["unet_launches"].get(kernel["name"], 0))
    # The command line: launches of every in-process main(argv) of phase cli (the training and the two --file
    # requests; the subprocess's are not counted).
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(cli_launches=cli["launches"].get(kernel["name"], 0))
    # The default request, transcript on: launches of phase transcript-infer's api.infer cold and warm, the
    # in-process --file and the separated request (four requests, each one window through the retry ladder).
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(transcript_infer_launches=transcript_infer["launches"].get(kernel["name"], 0))
    # The public constructors' defaults: launches of phase device-defaults (it runs no kernel).
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5):
        kernel.update(device_defaults_launches=device_defaults["launches"].get(kernel["name"], 0))
    # The operator's path: launches of the quality gate's workflow (its encodes and stability requests).
    for kernel in (k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5, resample_kernel):
        kernel.update(operator_launches=operator["launches"].get(kernel["name"], 0))
    say("run", wall_s=f"{time.perf_counter() - run_started:.1f}")
    print(json.dumps({"kernels": [k1["fused"], k1["spectrum"], k2, k2_f32, k2_bwd, k3, k4, k5, resample_kernel]}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
