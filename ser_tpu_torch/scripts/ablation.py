"""Building and timing copies of a kernel source with parts taken out (CUDA card only).

Without a profiler that sees inside a kernel (``ncu``), an ablation builds
copies of one ``csrc/*.cu`` source, each with some of its lines replaced, and
times each copy's entry point on the same inputs. The ablation scripts beside
this module (``log_mel_ablation``, ``flash_attention_f32_ablation``) name the
copies and the call; this module builds them (one ``nvcc`` per copy, all
started together) and times them.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ser_tpu_torch.ops import kernel_build

#: A copy: (name, [(text in the source, text put in its place)]).
Copy = tuple[str, list[tuple[str, str]]]


def build_copies(source: str, copies: tuple[Copy, ...]) -> dict[str, ctypes.CDLL]:
    """Build ``csrc/<source>.cu`` once per copy, each with its edits applied; the libraries by name.

    Raises ``SystemExit`` if an anchor is not in the source exactly once or
    ``nvcc`` fails.
    """
    text = (kernel_build.CSRC_DIR / f"{source}.cu").read_text(encoding="utf-8")
    out_dir = kernel_build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_build._nvcc()
    builds = {}
    for name, edits in copies:
        variant_text = text
        for anchor, replacement in edits:
            if variant_text.count(anchor) != 1:
                raise SystemExit(f"ablation: an anchor of {source} {name!r} is not in the source once.")
            variant_text = variant_text.replace(anchor, replacement)
        variant = out_dir / f"{source}_{name}.cu"
        variant.write_text(variant_text, encoding="utf-8")
        library = out_dir / f"lib{source}_{name}.so"
        command = [nvcc, *kernel_build.NVCC_FLAGS, "-I", str(kernel_build.CSRC_DIR), "-o", str(library), str(variant)]
        builds[name] = (subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), library)
    libraries = {}
    for name, (proc, library) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablation: nvcc failed for {source} {name!r}:\n{log[-3000:]}")
        libraries[name] = ctypes.CDLL(str(library))
    return libraries


def entry_point(library: ctypes.CDLL, source: str, entry: str):
    """``kernel_build.ENTRY_POINTS[source][entry]``'s function in ``library``, with its types set."""
    symbol, argtypes = kernel_build.ENTRY_POINTS[source][entry]
    function = getattr(library, symbol)
    function.argtypes, function.restype = argtypes, ctypes.c_int
    return function


def launch_ms(call, *, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``call`` in ms: CUDA events around ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / iters, 4)


__all__ = ["Copy", "build_copies", "entry_point", "launch_ms"]
