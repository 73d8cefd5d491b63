"""Encoder training script: RAVDESS WAVs or synthetic audio → training loop → checkpoints.

Counterpart of ``scripts/train_encoder_scaled.py``, with the same flags and
output lines: discover labeled clips, pack them into (K, B) super-batches,
train the whole Whisper-encoder classifier with ``make_sharded_train_loop``
(K optimizer steps per call), checkpoint the trajectory through
``ser_tpu_torch.parallel.checkpoint`` and resume exactly with ``--resume``.
It runs on the CUDA card (bf16 compute, kernels K1, K2 and K2-bwd) unless
``SER_TORCH_DEVICE=cpu`` asks for the CPU (float32 compute, the kernels'
plain versions). Run as one process per rank (``SER_DIST_*`` or torchrun),
it trains on the (data, model) mesh that ``SER_MESH_DATA_AXIS_SIZE`` /
``SER_MESH_MODEL_AXIS_SIZE`` shape: the global ``--batch`` split over the
data axis (which must divide it), the encoder tensor-parallel over the
model axis. Only rank 0 prints and writes checkpoints (every rank gathers
its shards for the write); a checkpoint resumes at another mesh shape.

The encoder's random weights come from ``random_whisper_encoder_state(seed)``
(a ``torch.Generator``), so they differ from the JAX script's for the same
seed; the head is drawn from numpy exactly as there.

Examples:
  # CPU, tiny dims, synthetic data:
  SER_TORCH_DEVICE=cpu python -m ser_tpu_torch.scripts.train_encoder_scaled --synthetic \\
      --model tiny --steps 4 --batch 2 --steps-per-dispatch 2 --checkpoint /tmp/ck

  # One H100, production dims (remat; batch 4, adafactor and 'dots' as the bench):
  python -m ser_tpu_torch.scripts.train_encoder_scaled --dataset ~/ravdess --model large \\
      --steps 100 --batch 4 --checkpoint ~/ck --resume

  # Four H100s of one host, dp2 x tp2 (NCCL):
  SER_MESH_MODEL_AXIS_SIZE=2 torchrun --nproc-per-node 4 -m ser_tpu_torch.scripts.train_encoder_scaled \\
      --synthetic --model large --batch 4
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _discover_clips(dataset: Path, emotions) -> list[tuple[Path, str]]:
    from ser_tpu_torch._internal.data.ravdess import extract_ravdess_emotion_code

    clips = []
    for path in sorted(dataset.rglob("*.wav")):
        code = extract_ravdess_emotion_code(path.name)
        label = emotions.get(code or "")
        if label:
            clips.append((path, label))
    return clips


def _load_batch(clips, labels_index, chunk_samples, rng):
    """Draws one (path, label) sample and returns (waveform, label, valid)."""
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file

    path, label = clips[int(rng.integers(0, len(clips)))]
    audio, sr = read_audio_file(str(path))
    if sr != 16000:
        raise SystemExit(f"{path}: expected 16 kHz WAV, got {sr}")
    valid = min(len(audio), chunk_samples)
    wave = np.zeros(chunk_samples, np.float32)
    wave[:valid] = audio[:chunk_samples]
    return wave, labels_index[label], valid


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=(__doc__ or "").splitlines()[0])
    parser.add_argument("--dataset", type=Path, help="RAVDESS-layout folder of WAVs.")
    parser.add_argument("--synthetic", action="store_true", help="Random waveforms.")
    parser.add_argument("--model", choices=("tiny", "large"), default="large")
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--steps-per-dispatch", type=int, default=3)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument(
        "--optimizer",
        choices=("adam", "adafactor"),
        default="adafactor",
        help="adafactor stores factored second moments instead of adam's two full moment trees.",
    )
    parser.add_argument(
        "--remat-policy",
        choices=("full", "dots"),
        default="dots",
        help="'dots' keeps the projection products' outputs across the remat boundary and "
        "recomputes the rest of each block; 'full' recomputes everything.",
    )
    parser.add_argument("--checkpoint", type=Path, help="Trajectory checkpoint dir.")
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=1,
        metavar="N",
        help="Save every N dispatches (a large-v3 trajectory is several GB per save).",
    )
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if not args.synthetic and not args.dataset:
        parser.error("one of --dataset or --synthetic is required")

    import torch
    import torch.distributed as dist

    from ser_tpu_torch._internal.config.bootstrap import reload_settings
    from ser_tpu_torch._internal.data.ravdess import RAVDESS_EMOTIONS
    from ser_tpu_torch.models.whisper import (
        CHUNK_SAMPLES,
        WhisperConfig,
        build_trainable_whisper_encoder,
        random_whisper_encoder_state,
    )
    from ser_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from ser_tpu_torch.parallel.distributed import initialize_distributed
    from ser_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size, build_mesh
    from ser_tpu_torch.parallel.optim import adafactor, adam
    from ser_tpu_torch.parallel.sharding import data_slice
    from ser_tpu_torch.parallel.train_step import (
        make_sharded_train_loop,
        mesh_device,
        place_optimizer_state,
        train_parameters,
    )

    labels = sorted(set(RAVDESS_EMOTIONS.values()))
    labels_index = {label: i for i, label in enumerate(labels)}
    config = WhisperConfig() if args.model == "large" else WhisperConfig.tiny()
    initialize_distributed()
    mesh = build_mesh(reload_settings().mesh)  # SER_MESH_* env controls dp×tp
    device = mesh_device(mesh)
    on_card = device.type == "cuda"
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *_args, **_kwargs: None)

    rng = np.random.default_rng(args.seed)
    clips = None
    if args.dataset:
        clips = _discover_clips(args.dataset.expanduser(), dict(RAVDESS_EMOTIONS))
        if not clips:
            raise SystemExit(f"No labeled RAVDESS WAVs under {args.dataset}")
        say(f"{len(clips)} labeled clips, {len(labels)} classes")

    data_axis, model_axis = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    say(f"mesh: data={data_axis} model={model_axis}")
    if args.batch % data_axis:
        raise SystemExit(
            f"--batch {args.batch} must be divisible by the mesh data axis "
            f"({data_axis}; set SER_MESH_DATA_AXIS_SIZE/"
            f"SER_MESH_MODEL_AXIS_SIZE to reshape)."
        )
    encoder = build_trainable_whisper_encoder(
        config,
        random_whisper_encoder_state(config, seed=args.seed, device=device),
        device=device,
        compute_dtype=torch.bfloat16 if on_card else torch.float32,
        remat=True,
        remat_policy=args.remat_policy,
        mesh=mesh,
    )
    optimizer = adafactor(args.learning_rate) if args.optimizer == "adafactor" else adam(args.learning_rate)
    place, run_steps, optimizer = make_sharded_train_loop(encoder, mesh, optimizer)

    head_rng = np.random.default_rng(args.seed)
    head = {
        "w1": (head_rng.standard_normal((2 * config.d_model, 300)) * 0.02).astype(np.float32),
        "b1": np.zeros(300, np.float32),
        "w2": (head_rng.standard_normal((300, len(labels))) * 0.02).astype(np.float32),
        "b2": np.zeros(len(labels), np.float32),
    }
    head = {name: torch.from_numpy(value) for name, value in head.items()}

    k, batch = args.steps_per_dispatch, args.batch

    def super_batch():
        waves = np.zeros((k, batch, CHUNK_SAMPLES), np.float32)
        labs = np.zeros((k, batch), np.int32)
        valid = np.full((k, batch), CHUNK_SAMPLES, np.int32)
        for i in range(k):
            for j in range(batch):
                if clips is None:
                    waves[i, j] = 0.1 * rng.standard_normal(CHUNK_SAMPLES)
                    labs[i, j] = rng.integers(0, len(labels))
                else:
                    waves[i, j], labs[i, j], valid[i, j] = _load_batch(clips, labels_index, CHUNK_SAMPLES, rng)
        return (torch.from_numpy(waves).to(device), torch.from_numpy(labs).to(device),
                torch.from_numpy(valid).to(device))

    def place_batch(waves, labs, valid):
        """This rank's slice (dim 1) of a super-batch."""
        return tuple(data_slice(mesh, tensor, 1) for tensor in (waves, labs, valid))

    global_batch = super_batch()
    head, waves, labs = place(head, *global_batch[:2])
    valid = data_slice(mesh, global_batch[2], 1)
    opt_state = place_optimizer_state(mesh, optimizer.init(train_parameters(encoder, head)))
    step = 0
    ckpt_path = args.checkpoint / "trainstate" if args.checkpoint else None
    if args.resume and ckpt_path and (ckpt_path.exists() or ckpt_path.with_name("trainstate.staging").exists()):
        encoder_params, head_params, opt_state, step = restore_train_state(ckpt_path, map_location=device, mesh=mesh)
        encoder.load_state_dict(encoder_params, strict=True)
        head, _, _ = place(head_params, *global_batch[:2])
        opt_state = place_optimizer_state(mesh, opt_state)
        say(f"resumed at step {step}")

    dispatch = 0
    while step < args.steps:
        start = time.perf_counter()
        head, opt_state, losses = run_steps(head, opt_state, waves, labs, valid)
        losses = losses.cpu().numpy()  # completion barrier
        elapsed = time.perf_counter() - start
        step += k
        audio_s = k * batch * CHUNK_SAMPLES / 16000.0
        say(
            f"step {step:>5}  loss {losses[-1]:.4f}  "
            f"{audio_s / elapsed:7.1f} audio_s/s  {elapsed / k * 1000:6.0f} ms/step"
        )
        dispatch += 1
        if ckpt_path and (dispatch % args.checkpoint_every == 0 or step >= args.steps):
            save_train_state(
                ckpt_path, encoder_params=encoder.state_dict(), head_params=head, opt_state=opt_state, step=step,
                mesh=mesh,
            )
        if step < args.steps:
            waves, labs, valid = place_batch(*super_batch())
    say("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
