"""RAVDESS evaluation harness: a trained profile against the labelled corpus.

Counterpart of ``scripts/evaluate_profile.py``, with the same flags and the
same JSON report: runs the trained profile over the configured dataset
(``SER_DATASET_FOLDER``; the encoder profiles through ``infer_many``, the fast
profile file by file), takes each clip's dominant label (its longest
segment's), and reports accuracy, UAR, macro-F1 and per-class recall
(``_internal/train/metrics.py``) with the throughput in audio-seconds per
second. It runs on the CUDA card unless ``SER_TORCH_DEVICE=cpu`` asks for the
CPU. Under a process group (``SER_DIST_*`` or torchrun) ``infer_many``
splits the files over the data ranks, and rank 0 reports.

Usage: python -m ser_tpu_torch.scripts.evaluate_profile [--profile fast] [--limit N] [--output report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _dominant_label(result) -> str:
    """Longest-duration segment label (clip-level prediction)."""
    if not result.segments:
        return ""
    best = max(result.segments, key=lambda s: s.end_seconds - s.start_seconds)
    return best.emotion


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=(__doc__ or "").splitlines()[0])
    parser.add_argument("--profile", default="fast", choices=("fast", "medium", "accurate", "accurate-research"))
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ser_tpu_torch._internal.config.bootstrap import reload_settings
    from ser_tpu_torch._internal.data import loader
    from ser_tpu_torch._internal.data.ravdess import extract_ravdess_emotion_code
    from ser_tpu_torch._internal.train.metrics import accuracy, compute_ser_metrics
    from ser_tpu_torch._internal.utils.audio_io import read_audio_file
    from ser_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed()
    settings = reload_settings()
    emotion_map = dict(settings.emotions)
    files = []
    for path in loader.discover_dataset_files(settings):
        label = emotion_map.get(extract_ravdess_emotion_code(path.rsplit("/", 1)[-1]) or "")
        if label:
            files.append((path, label))
    if args.limit:
        files = files[: args.limit]
    if not files:
        print("No labeled files found (SER_DATASET_FOLDER).", file=sys.stderr)
        return 2

    audio, sample_rate = read_audio_file(files[0][0], audio_read_config=settings.audio_read)
    audio_seconds = audio.size / sample_rate * len(files)  # uniform-corpus estimate

    started = time.perf_counter()
    y_true, y_pred = [], []
    if args.profile == "fast":
        from ser_tpu_torch._internal.models.emotion_model import load_model, predict_emotions_detailed

        loaded = load_model(settings=settings, profile="fast")
        for path, label in files:
            result = predict_emotions_detailed(path, settings=settings, loaded=loaded)
            y_true.append(label)
            y_pred.append(_dominant_label(result))
    else:
        from ser_tpu_torch.parallel.batch_inference import infer_many

        rows = infer_many([p for p, _ in files], profile=args.profile, settings=settings)
        for (path, label), row in zip(files, rows):
            if row.result is None:
                print(f"skip {path}: {row.error}", file=sys.stderr)
                continue
            y_true.append(label)
            y_pred.append(_dominant_label(row.result))
    elapsed = time.perf_counter() - started
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0

    metrics = compute_ser_metrics(y_true=y_true, y_pred=y_pred)
    payload = {
        "profile": args.profile,
        "files": len(y_true),
        "accuracy": accuracy(y_true, y_pred),
        "uar": metrics["uar"],
        "macro_f1": metrics["macro_f1"],
        "per_class_recall": metrics["per_class_recall"],
        "elapsed_seconds": round(elapsed, 2),
        "audio_seconds_per_second": round(audio_seconds / elapsed, 2) if elapsed else None,
    }
    output = json.dumps(payload, indent=2)
    if args.output:
        Path(args.output).write_text(output, encoding="utf-8")
    print(output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
