"""Reads a local HF checkpoint's tensors as numpy arrays, without ``safetensors``.

Shared by the port's checkpoint loaders (Whisper, wav2vec2). The card's
machine has neither ``safetensors`` nor ``transformers``, so ``*.safetensors``
files are parsed here; ``pytorch_model*.bin`` files load through
``torch.load(weights_only=True)``. bf16 tensors are widened to float32, as the
JAX package's loaders do (numpy has no bf16).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

_SAFETENSORS_DTYPES = {
    "F64": "<f8",
    "F32": "<f4",
    "F16": "<f2",
    "I64": "<i8",
    "I32": "<i4",
    "I16": "<i2",
    "I8": "i1",
    "U8": "u1",
    "BOOL": "?",
}


def read_safetensors(path: Path) -> dict[str, np.ndarray]:
    """A ``*.safetensors`` file as numpy arrays (bf16 widened to float32).

    The format: an 8-byte little-endian header length, a JSON header mapping
    each name to its dtype, shape and byte range, then the raw tensors.
    """
    with path.open("rb") as handle:
        (header_len,) = struct.unpack("<Q", handle.read(8))
        header = json.loads(handle.read(header_len))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
    tensors: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            flat = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            flat = raw.view(_SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"Unsupported safetensors dtype {info['dtype']!r} for {name!r} in {path}.")
        tensors[name] = np.array(flat.reshape(info["shape"]))
    return tensors


def read_hf_tensors(model_dir) -> dict[str, np.ndarray]:
    """A local HF checkpoint's tensors as numpy (safetensors or ``pytorch_model*.bin``)."""
    model_dir = Path(model_dir)
    safetensor_files = sorted(model_dir.glob("*.safetensors"))
    merged: dict[str, np.ndarray] = {}
    if safetensor_files:
        for file in safetensor_files:
            merged.update(read_safetensors(file))
        return merged
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(f"No model weights (*.safetensors / *.bin) in {model_dir}.")
    for file in bin_files:
        state = torch.load(str(file), map_location="cpu", weights_only=True)
        merged.update(
            {
                key: (value.float() if value.dtype == torch.bfloat16 else value).numpy()
                for key, value in state.items()
            }
        )
    return merged


__all__ = ["read_hf_tensors", "read_safetensors"]
