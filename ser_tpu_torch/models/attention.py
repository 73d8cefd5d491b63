"""Bidirectional multi-head attention: kernel K2 on the card, plain version on CPU.

Counterpart of ``ser_tpu/models/attention.py``. Kernel K2 (``flash_attention``,
source ``csrc/flash_attention.cu``) replaces the TPU kernel behind
``_flash_path`` there (``jax.experimental.pallas.ops.tpu.flash_attention``):
softmax(QKᵀ/√D)·V with float32 softmax and accumulation, bf16 in and out,
D = 64, and an optional (B, T) key mask. A CUDA tensor launches the kernel;
a CPU tensor takes ``attention_reference``, the counterpart of
``_einsum_path`` (scores / √D, a −1e30 bias on masked keys, softmax in
float32). There is no environment switch between the two.
"""

from __future__ import annotations

import math

import torch

from ser_tpu_torch.ops import kernel_build

#: Launches of kernel K2 (its wrapper adds one per launch).
COUNTER = kernel_build.KernelCounter("flash_attention_fwd")

_HEAD_DIM = 64


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of K2 in the inputs' dtype, softmax in float32.

    (B, T, H, D) → (B, T, H, D); ``frame_mask`` (B, T) bool marks valid keys;
    √D is taken in ``compute_dtype``, as ``ser_tpu``'s ``_einsum_path`` does.
    """
    root_d = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=compute_dtype, device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root_d
    if frame_mask is not None:
        bias = torch.where(frame_mask[:, None, None, :], 0.0, -1e30)
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel K2 on CUDA tensors: (B, T, H, 64) bf16 q, k, v → (B, T, H, 64) bf16.

    Replaces the Pallas ``flash_attention`` behind ``ser_tpu/models/attention.py::
    _flash_path``. On the H100 the tensor cores bound it: at (8, 1500, 20, 64)
    one call is 92 GFLOP against 123 MB of q, k, v and out. The kernel keeps
    the scores in registers (online softmax), runs both products on the tensor
    cores and overlaps the next K/V tile's load with the current tile's math
    (``csrc/flash_attention.cu``).
    """
    batch, seq, heads, head_dim = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention takes q, k, v on one CUDA device.")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention takes bfloat16 q, k, v.")
    if k.shape != q.shape or v.shape != q.shape or head_dim != _HEAD_DIM:
        raise ValueError(f"flash_attention takes equal (B, T, H, {_HEAD_DIM}) shapes.")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned q, k, v.")
    mask_ptr = None
    mask = None
    if frame_mask is not None:
        if frame_mask.shape != (batch, seq):
            raise ValueError(f"frame_mask must be (B, T) = {(batch, seq)}.")
        mask = frame_mask.to(device=q.device, dtype=torch.uint8).contiguous()
        mask_ptr = mask.data_ptr()
    entry = kernel_build.load("flash_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        batch, seq, heads, head_dim, 1.0 / math.sqrt(head_dim), stream,
    )
    kernel_build.check(code, "flash_attention_fwd")
    COUNTER.launches += 1
    del mask  # the launch is enqueued; the caching allocator keeps the block stream-ordered
    return out


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bidirectional MHA. q/k/v: (B, T, H, D) → (B, T, H, D).

    ``frame_mask`` (B, T) excludes padded frames from the keys. CUDA tensors
    run kernel K2; CPU tensors run :func:`attention_reference`.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, frame_mask=frame_mask, compute_dtype=compute_dtype)
    return flash_attention(q, k, v, frame_mask=frame_mask)


__all__ = ["COUNTER", "attention_reference", "flash_attention", "multi_head_attention"]
