"""Device and dtype resolution of the PyTorch port.

The port runs on the CUDA card unless the CPU is asked for by name: with no
card, ``auto`` (and ``cuda``/``gpu``) raises instead of falling back to the
CPU. On the card the accurate profile's ``auto``/``bfloat16`` request gives
bf16; the CPU always computes in float32.
"""

from __future__ import annotations

import pytest
import torch

from ser_tpu_torch._internal.config.schema import TorchRuntimeConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device, resolve_feature_runtime
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError


@pytest.mark.parametrize("request_name", ["auto", "", "cuda", "gpu", "cuda:0"])
def test_accelerator_requests_raise_without_a_card(monkeypatch, request_name) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        resolve_device(request_name)


@pytest.mark.parametrize(("request_name", "expected"), [("auto", "cuda"), ("cuda:1", "cuda:1"), ("cpu", "cpu")])
def test_device_with_a_card(monkeypatch, request_name, expected) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(request_name) == torch.device(expected)


def test_unknown_device_is_refused() -> None:
    with pytest.raises(ValueError, match="Unknown torch device"):
        resolve_device("tpu")


@pytest.mark.parametrize(
    ("device", "dtype", "expected"),
    [
        ("cpu", "auto", "float32"),
        ("cpu", "bfloat16", "float32"),
        ("cpu", "float32", "float32"),
        ("auto", "auto", "bfloat16"),
        ("cuda", "bfloat16", "bfloat16"),
        ("cuda", "float16", "bfloat16"),
    ],
)
def test_dtype_policy(monkeypatch, device, dtype, expected) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolved = resolve_feature_runtime(
        "jax_whisper_encoder", torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype)
    )
    assert resolved.dtype == expected
    assert resolved.torch_dtype == (torch.bfloat16 if expected == "bfloat16" else torch.float32)


@pytest.mark.parametrize(("device", "dtype"), [("cuda", "float32"), ("cpu", "int8"), ("cuda", "int8")])
def test_unported_dtypes_raise(monkeypatch, device, dtype) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_feature_runtime("jax_whisper_encoder", torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype))
