"""Builds and loads the port's hand-written CUDA kernels (``ser_tpu_torch/csrc``).

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and bound with ``ctypes``. The
build runs at first use, never at import: every source gets its own ``nvcc``
process and all of them start together. Libraries land in
``build/torch_kernels/`` at the checkout root, named by a hash of their source
and flags, so an edited source is rebuilt and an unchanged one is reused.
``nvcc``'s ``-Xptxas=-v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>.log``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on any other value than 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_POINTER, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Each source's C entry points, by the name ``load`` takes, with their symbols
#: and argument types; every entry point takes the stream last and returns a
#: CUDA error code (int).
ENTRY_POINTS = {
    "log_mel": {"log_mel": ("ser_power_mel_log", [_POINTER] * 3 + [_INT] * 5 + [_POINTER])},
    "flash_attention": {
        "flash_attention": ("ser_flash_attention_fwd", [_POINTER] * 6 + [_INT] * 5 + [_FLOAT, _POINTER]),
        "flash_attention_bwd": ("ser_flash_attention_bwd", [_POINTER] * 10 + [_INT] * 5 + [_FLOAT, _POINTER]),
    },
    "decode_step": {
        "ln_qkv_project": ("ser_ln_qkv_project", [_POINTER] * 6 + [_INT] * 3 + [_FLOAT, _POINTER]),
        "self_attend_and_out": (
            "ser_self_attend_and_out",
            [_POINTER, _INT] + [_POINTER] * 7 + [_INT] * 5 + [_FLOAT, _POINTER],
        ),
        "cross_attention_step": (
            "ser_cross_attention_step",
            [_POINTER] * 13 + [_INT] * 4 + [_FLOAT, _FLOAT, _POINTER],
        ),
    },
}

_ENTRIES: dict[str, Callable[..., int]] = {}
_LOCK = threading.Lock()


@dataclass
class KernelCounter:
    """Launch count of one kernel: its wrapper adds one per launch, nowhere else."""

    name: str
    launches: int = 0


class KernelBuildError(RuntimeError):
    """nvcc failed, or is missing, for one of the port's kernel sources."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error code."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for candidate in candidates:
        if candidate.is_file():
            return str(candidate)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH).")


def sources() -> list[Path]:
    """Every kernel source of the port."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compiles every source that has no up-to-date library, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {source.stem: (source, _library_path(source)) for source in sources()}
    pending = {name: pair for name, pair in targets.items() if not pair[1].is_file()}
    if pending:
        nvcc = _nvcc()
        procs = {}
        for name, (source, library) in pending.items():
            partial = library.with_suffix(f".{os.getpid()}.tmp")
            command = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(partial), str(source)]
            procs[name] = (
                subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                partial,
                library,
            )
        failures = []
        for name, (proc, partial, library) in procs.items():
            output, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(output, encoding="utf-8")
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{output[-4000:]}")
                partial.unlink(missing_ok=True)
            else:
                os.replace(partial, library)
        if failures:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return {name: pair[1] for name, pair in targets.items()}


def load(name: str) -> Callable[..., int]:
    """The C entry point ``name`` of ``ENTRY_POINTS``, its signature declared once.

    The first call builds every source and loads every library.
    """
    entry = _ENTRIES.get(name)
    if entry is not None:
        return entry
    with _LOCK:
        if not _ENTRIES:
            for stem, path in build_all().items():
                library = ctypes.CDLL(str(path))
                for entry_name, (symbol, argtypes) in ENTRY_POINTS[stem].items():
                    function = getattr(library, symbol)
                    function.argtypes = argtypes
                    function.restype = _INT
                    _ENTRIES[entry_name] = function
        return _ENTRIES[name]


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raises when grad mode is on and an input requires grad.

    A kernel's output is filled through ``ctypes`` and is not connected to
    autograd; a kernel without an autograd Function would cut the gradient
    without a word.
    """
    if torch.is_grad_enabled() and any(tensor.requires_grad for tensor in tensors):
        raise RuntimeError(
            f"{kernel} has no backward on the card: call it on inputs that do not require grad "
            "(or under torch.no_grad())."
        )


def check(code: int, kernel: str) -> None:
    """Raises :class:`KernelLaunchError` for a non-zero CUDA error code."""
    if code != 0:
        raise KernelLaunchError(f"{kernel} launch failed with CUDA error {code}.")


def ptxas_report(name: str) -> str:
    """The last build's ``-Xptxas=-v`` lines for one source, spills included ('' when not built here)."""
    log = BUILD_DIR / f"{name}.log"
    if not log.is_file():
        return ""
    lines = log.read_text(encoding="utf-8").splitlines()
    return "\n".join(line for line in lines if "ptxas info" in line or "bytes spill" in line)


__all__ = [
    "BUILD_DIR",
    "CSRC_DIR",
    "ENTRY_POINTS",
    "KernelBuildError",
    "KernelCounter",
    "KernelLaunchError",
    "build_all",
    "check",
    "load",
    "ptxas_report",
    "refuse_grad",
    "sources",
]
