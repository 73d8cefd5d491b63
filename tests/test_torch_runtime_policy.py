"""Device and dtype resolution of the PyTorch port.

The port runs on the CUDA card unless the CPU is asked for by name: with no
card, ``auto`` (and ``cuda``/``gpu``) raises instead of falling back to the
CPU. On the card ``auto`` gives each backend's dtype as in the JAX package
(bf16 for ``jax_xlsr`` and ``jax_whisper_encoder``, float32 for
``handcrafted``), ``bfloat16`` bf16 and ``float32`` float32 (kernel K2-f32);
the CPU always computes in float32. ``int8`` raises. A float32 Whisper
decode on the card raises at construction (K3-K5 take bf16 only).
"""

from __future__ import annotations

import pytest
import torch

from ser_tpu._internal.config.schema import TorchRuntimeConfig as JaxTorchRuntimeConfig
from ser_tpu._internal.repr import runtime_policy as jax_policy
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


@pytest.mark.parametrize(("device", "dtype"), [("cuda", "w8a8"), ("cpu", "int8"), ("cuda", "int8")])
def test_unported_dtypes_raise(monkeypatch, device, dtype) -> None:
    """int8 (alias w8a8), once refused, is the Whisper encoder's W8A8 row: int8 on
    the card and on the CPU, computing in bf16 on the card and float32 on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolved = resolve_feature_runtime("jax_whisper_encoder", torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype))
    assert resolved.dtype == "int8"
    assert resolved.torch_dtype == (torch.bfloat16 if device == "cuda" else torch.float32)


@pytest.mark.parametrize("backend_id", ["jax_xlsr", "jax_whisper_encoder", "emotion2vec", "handcrafted"])
@pytest.mark.parametrize(
    ("device", "dtype"),
    [("cuda", "auto"), ("cuda", "bfloat16"), ("cuda", "float32"), ("cuda", "float16"), ("cpu", "auto"),
     ("cpu", "bfloat16"), ("cpu", "float32")],
)
def test_backend_dtypes_match_ser_tpu(monkeypatch, backend_id, device, dtype) -> None:
    """Per-backend supported and ``auto`` dtypes as in the JAX package on a TPU host, the card in the TPU's place.

    The JAX backends compute in float32 on the CPU whatever the policy says
    (``ser_tpu/_internal/repr/encoders.py``); the port's policy says so itself.
    """
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(jax_policy, "_available_kinds", lambda: ("cpu", "tpu"))
    ours = resolve_feature_runtime(backend_id, torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype))
    reference = jax_policy.resolve_feature_runtime(
        backend_id, torch_runtime=JaxTorchRuntimeConfig(device="tpu" if device == "cuda" else "cpu", dtype=dtype)
    )
    assert reference.device_kind == ("tpu" if device == "cuda" else "cpu")
    assert ours.dtype == (reference.dtype if device == "cuda" else "float32")


def test_float32_on_the_card_is_allowed_and_stays_on_the_card(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolved = resolve_feature_runtime("jax_xlsr", torch_runtime=TorchRuntimeConfig(device="auto", dtype="float32"))
    assert (resolved.device, resolved.dtype, resolved.torch_dtype) == (torch.device("cuda"), "float32", torch.float32)


@pytest.mark.parametrize("dtype", ["auto", "float32", "bfloat16"])
def test_no_request_falls_back_to_the_cpu(monkeypatch, dtype) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        resolve_feature_runtime("jax_xlsr", torch_runtime=TorchRuntimeConfig(device="auto", dtype=dtype))


@pytest.mark.parametrize(("device", "dtype", "expected"), [("auto", "auto", "bfloat16"), ("cuda", "int8", "bfloat16"),
                                                           ("cpu", "auto", "float32"), ("cpu", "int8", "float32")])
def test_transcript_lane_auto_is_bf16_on_the_card(monkeypatch, device, dtype, expected) -> None:
    """The transcript lane (``jax_whisper``) resolved ``auto`` to float32, which the decode
    refuses on the card; it is bf16 there, the JAX transcript's first precision."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolved = resolve_feature_runtime("jax_whisper", torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype))
    assert resolved.dtype == expected
