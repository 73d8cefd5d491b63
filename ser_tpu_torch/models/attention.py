"""Bidirectional multi-head attention: kernel K2 and its backward on the card, plain version on CPU.

Counterpart of ``ser_tpu/models/attention.py``. Kernel K2 (``flash_attention``,
source ``csrc/flash_attention.cu``) replaces the TPU kernel behind
``_flash_path`` there (``jax.experimental.pallas.ops.tpu.flash_attention``):
softmax(QKᵀ/√D)·V with float32 softmax and accumulation, bf16 in and out,
D = 64, and an optional (B, T) key mask. K2-bwd (``flash_attention_backward``,
the same source) replaces that kernel's dkv and dq backward kernels, which
encoder training runs. ``FlashAttention`` is the ``torch.autograd.Function``
that joins the two: its forward keeps K2's log-sum-exp, its backward launches
K2-bwd.

A CUDA tensor launches the kernels; a CPU tensor takes ``attention_reference``,
the counterpart of ``_einsum_path`` (scores / √D, a −1e30 bias on masked keys,
softmax in float32), which PyTorch differentiates, and
``attention_backward_reference``, the backward's formulas step by step. There
is no environment switch between the two. No JAX path takes the gradient of a
masked attention, so neither does this one: ``FlashAttention`` raises on a
frame mask when a gradient is required.
"""

from __future__ import annotations

import math

import torch

from ser_tpu_torch.ops import kernel_build

#: Launches of kernel K2 (its wrapper adds one per launch).
COUNTER = kernel_build.KernelCounter("flash_attention_fwd")
#: Calls of K2-bwd (its wrapper adds one per call, which launches the Δ, dK/dV and dQ kernels).
BWD_COUNTER = kernel_build.KernelCounter("flash_attention_bwd")

_HEAD_DIM = 64
_TILE = 128  # the kernels' query and key tile (kBlockQ): the log-sum-exp and key-mask rows are padded to it


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


def _stat_dtype(q: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient check)."""
    return torch.promote_types(q.dtype, torch.float32)


def attention_with_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 with its log-sum-exp: out (B, T, H, D) in q's dtype, lse (B, H, T).

    lse = logsumexp(q·kᵀ·scale) per query, in natural-log units; computed in
    float32 (float64 for float64 inputs).
    """
    dtype = _stat_dtype(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), k.to(dtype)) * scale
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.exp(scores - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype)).to(q.dtype), lse


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2-bwd: (dq, dk, dv), each (B, T, H, D), in float32.

    The kernel's formulas step by step (float64 for float64 inputs): with
    S = q·kᵀ·scale and P = exp(S − lse), dV = Pᵀ·dO, dP = dO·Vᵀ,
    Δ = rowsum(dO ∘ O), dS = P ∘ (dP − Δ), dQ = dS·K·scale, dK = dSᵀ·Q·scale.
    ``lse`` is (B, H, T). On no card path: the tests and ``chip_smoke.py`` hold
    the kernel to it.
    """
    dtype = _stat_dtype(q)
    q, k, v, out, dout = (t.to(dtype) for t in (q, k, v, out, dout))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(scores - lse.to(dtype)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    delta = (dout * out).sum(dim=-1).transpose(1, 2)  # (B, H, T)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def _check_operands(kernel: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{kernel} takes its operands on one CUDA device.")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{kernel} takes bfloat16 operands.")
    if any(t.shape != q.shape for t in tensors) or q.shape[-1] != _HEAD_DIM:
        raise ValueError(f"{kernel} takes equal (B, T, H, {_HEAD_DIM}) shapes.")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{kernel} takes contiguous, 16-byte aligned operands.")


def _padded_len(seq: int) -> int:
    return -(-seq // _TILE) * _TILE


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors: (B, T, H, 64) bf16 q, k, v → (B, T, H, 64) bf16.

    With ``return_lse`` it also returns the float32 (B, H, T) log-sum-exp of
    the scaled scores (natural log), a view of a (B, H, T rounded up to 128)
    buffer that K2-bwd reads; without it the kernel writes none.

    Replaces the Pallas ``flash_attention`` behind ``ser_tpu/models/attention.py::
    _flash_path``. On the H100 the tensor cores bound it: at (8, 1500, 20, 64)
    one call is 92 GFLOP (0.093 ms at the bf16 peak) against 123 MB of q, k,
    v and out, and at D = 64 its 360 M exponentials take about as long on the
    special-function units. The kernel (``csrc/flash_attention.cu``) is a
    persistent, warp-specialised Hopper kernel: a producer warp streams K/V
    tiles by TMA into an mbarrier ring, two consumer warpgroups run Q·Kᵀ and
    P·V as ``wgmma`` with the online softmax in registers, and take turns on
    the tensor cores so that one's softmax runs under the other's products.
    It has no autograd: :class:`FlashAttention` is the differentiable route.
    """
    _check_operands("flash_attention", q, k, v)
    kernel_build.refuse_grad("flash_attention", q, k, v)
    batch, seq, heads, head_dim = q.shape
    padded = _padded_len(seq)
    mask_ptr = None
    mask = None
    if frame_mask is not None:
        if frame_mask.shape != (batch, seq):
            raise ValueError(f"frame_mask must be (B, T) = {(batch, seq)}.")
        # Rows of T rounded up to the key tile: each tile's bytes arrive in one aligned copy.
        mask = torch.zeros((batch, padded), dtype=torch.uint8, device=q.device)
        mask[:, :seq] = frame_mask
        mask_ptr = mask.data_ptr()
    entry = kernel_build.load("flash_attention")
    out = torch.empty_like(q)
    lse = None
    if return_lse:
        lse = torch.empty((batch, heads, padded), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(), batch, seq, heads, head_dim, padded,
        1.0 / math.sqrt(head_dim), stream,
    )
    kernel_build.check(code, "flash_attention_fwd")
    COUNTER.launches += 1
    del mask  # the launch is enqueued; the caching allocator keeps the block stream-ordered
    if lse is None:
        return out
    return out, lse[..., :seq]


def _padded_lse(lse: torch.Tensor, batch: int, heads: int, seq: int) -> torch.Tensor:
    """``lse`` (B, H, T) as the kernels read it: rows of T rounded up to 128 floats.

    The view :func:`flash_attention` returns already is; anything else is
    copied into such a buffer. The kernels never read the values past T.
    """
    padded = _padded_len(seq)
    if lse.dtype != torch.float32 or lse.shape != (batch, heads, seq):
        raise ValueError(f"lse must be float32 (B, H, T) = {(batch, heads, seq)}.")
    fits = lse.untyped_storage().nbytes() >= (lse.storage_offset() + batch * heads * padded) * 4
    if lse.stride() == (heads * padded, padded, 1) and fits and lse.data_ptr() % 16 == 0:
        return lse
    buffer = torch.zeros((batch, heads, padded), dtype=torch.float32, device=lse.device)
    buffer[..., :seq] = lse
    return buffer[..., :seq]


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-bwd: (dq, dk, dv) of unmasked attention, each like q.

    CUDA tensors (bf16, (B, T, H, 64), contiguous) launch the kernels: Δ, then
    dK/dV, then dQ (``csrc/flash_attention.cu``), the dQ grid started under
    the tail of the dK/dV grid. Replaces the Pallas ``flash_attention``'s dkv
    and dq backward kernels. At the training step's (4, 1500, 20, 64) the
    tensor cores bound it: five T×T×D products, 115 GFLOP (0.117 ms), against
    about 123 MB of operands; the two kernels recompute S and dP in each, 7
    products (about 0.16 ms), so that dQ needs no atomics and keeps its bits
    from run to run. Both are warp-specialised Hopper kernels like K2
    (``wgmma``, TMA into an mbarrier ring, two consumer warpgroups taking
    turns). CPU tensors take :func:`attention_backward_reference`, cast to q's
    dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        grads = attention_backward_reference(q, k, v, out, lse, dout, scale)
        return tuple(g.to(q.dtype) for g in grads)
    _check_operands("flash_attention_backward", q, k, v, out, dout)
    kernel_build.refuse_grad("flash_attention_backward", q, k, v, out, lse, dout)
    batch, seq, heads, head_dim = q.shape
    lse = _padded_lse(lse, batch, heads, seq)
    padded = lse.stride(1)
    delta = torch.empty((batch, heads, padded), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernel_build.load("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch, seq, heads, head_dim, padded,
        scale, stream,
    )
    kernel_build.check(code, "flash_attention_bwd")
    BWD_COUNTER.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable K2: the forward keeps the log-sum-exp, the backward is K2-bwd.

    ``FlashAttention.apply(q, k, v, frame_mask=None)``, (B, T, H, D). On CUDA
    tensors both directions are kernels; on CPU tensors the plain versions
    (``attention_with_lse_reference``, ``attention_backward_reference``), so
    that ``torch.autograd.gradcheck`` can hold the backward's formulas in
    float64. A frame mask with a gradient required raises: no path of the JAX
    package trains through a masked attention (``ROADMAP.md``).
    """

    @staticmethod
    def forward(ctx, q, k, v, frame_mask=None):  # type: ignore[override]
        if frame_mask is not None:
            if any(ctx.needs_input_grad[:3]):
                raise NotImplementedError(
                    "The backward of a masked attention is not ported to ser_tpu_torch; see ROADMAP.md."
                )
            return multi_head_attention(q, k, v, frame_mask=frame_mask)
        if q.device.type == "cpu":
            out, lse = attention_with_lse_reference(q, k, v, 1.0 / math.sqrt(q.shape[-1]))
        else:
            out, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout.contiguous())
        return dq, dk, dv, None


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bidirectional MHA. q/k/v: (B, T, H, D) → (B, T, H, D).

    ``frame_mask`` (B, T) excludes padded frames from the keys. CPU tensors
    run :func:`attention_reference`, which autograd differentiates. CUDA
    tensors run kernel K2, through :class:`FlashAttention` (K2-bwd as its
    backward) when grad mode is on and an input requires grad.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, frame_mask=frame_mask, compute_dtype=compute_dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, frame_mask)
    return flash_attention(q, k, v, frame_mask=frame_mask)


__all__ = [
    "BWD_COUNTER",
    "COUNTER",
    "FlashAttention",
    "attention_backward_reference",
    "attention_reference",
    "attention_with_lse_reference",
    "flash_attention",
    "flash_attention_backward",
    "multi_head_attention",
]
