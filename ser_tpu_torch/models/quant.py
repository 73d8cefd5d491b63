"""W8A8 int8 projections: the opt-in int8 lanes of the encoder and the decode.

Counterpart of ``ser_tpu/models/quant.py`` (``QuantDense``) and of the int8
products of ``ser_tpu/models/whisper_decode.py`` (``_dense_int8``). The
scheme is the JAX package's: symmetric int8, one weight scale per output
channel (column abs-max / 127), one activation scale per token (row abs-max /
127, computed at each call), an exact int32 accumulator, then the float32
dequant ``acc * (ascale * wscale)`` with the bias added in float32 before the
cast to the compute dtype. ``torch.round`` rounds half to even, as
``jnp.round`` does, and an int32 product is exact in both packages. Each
scale is the abs-max times float32(1/127): XLA compiles the JAX package's
division by the constant 127 into that product, inside every jitted program
that quantizes (the decode loops, the encoder), so the port computes it so too
and its int8 values are the JAX package's bit for bit.

The products are ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card): a plain
matrix product that the JAX package computes outside Pallas
(``lax.dot_general`` with ``preferred_element_type=int32``), not a port of a
TPU kernel. On the card ``torch._int_mm`` refuses an ``m`` of 16 rows or
fewer and an ``n`` or ``k`` that is not a multiple of 8. The weights are
stored with their output channels padded with zero rows to a multiple of 8,
and :func:`int8_product` pads the activation rows with zeros to 32 on the
card: a zero row or column adds nothing to an exact int32 sum, and the result
is sliced back. An operand the card still refuses raises
(:func:`int8_matmul`); nothing falls back to another product.

Deliberate difference: ``QuantDense`` quantizes its weights once, when first
called (or when ``build_whisper_encoder`` builds an int8 encoder), and again
only if the weight tensor changes; the JAX module requantizes inside every
jitted call. The weights are frozen at inference, so the bits are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

#: ``torch._int_mm``'s rules on the card: m > 16, and n, k multiples of 8.
_CARD_MIN_ROWS = 17
_CARD_ALIGN = 8
#: Rows an activation operand is padded to on the card when it has too few.
_CARD_PAD_ROWS = 32
#: float32(1/127): the scales are abs-max × this, as XLA compiles abs-max / 127.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _on_card(tensor: torch.Tensor) -> bool:
    return tensor.device.type == "cuda"


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def quantize_columns(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) weights → int8 (K, N) and float32 per-output-channel scales (N,)."""
    wf = kernel.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=0), min=1e-8) * _INV_127
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) activations → int8 (..., K) and float32 per-token scales (..., 1)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * _INV_127
    return torch.round(xf / scale).to(torch.int8), scale


def int8_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32 through ``torch._int_mm``.

    On the card the operands must already meet cuBLASLt's rules (M > 16; K
    and N multiples of 8): a shape it would refuse raises ``ValueError`` here,
    naming the rule. The CPU takes any shape.
    """
    if _on_card(a8):
        m, k = a8.shape
        n = b8.shape[1]
        if m < _CARD_MIN_ROWS or k % _CARD_ALIGN or n % _CARD_ALIGN:
            raise ValueError(
                f"torch._int_mm on the card needs more than 16 rows and K, N multiples of 8; "
                f"got ({m}, {k}) x ({k}, {n}). Pad the operands (int8_product)."
            )
    return torch._int_mm(a8, b8)


class Int8Weight:
    """A quantized (K, N) projection: int8 weights, float32 scales, the optional bias.

    ``w8`` and ``scale`` have the JAX package's shapes, (K, N) and (N,).
    ``w8`` is a view of column-major storage whose output channels are
    padded with zero rows to a multiple of 8 (``padded``, (K, N8)), the
    operand ``torch._int_mm`` is given.
    """

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor | None) -> None:
        w8, scale = quantize_columns(kernel)
        k, n = w8.shape
        storage = torch.zeros((_round_up(n, _CARD_ALIGN), k), dtype=torch.int8, device=w8.device)
        storage[:n] = w8.t()
        self.padded = storage.t()
        self.w8 = self.padded[:, :n]
        self.scale = scale
        self.bias = None if bias is None else bias.detach()


def int8_product(a8: torch.Tensor, weight: Int8Weight) -> torch.Tensor:
    """(M, K) int8 activations × a quantized weight → (M, N) int32, padded as the card needs."""
    m = a8.shape[0]
    if _on_card(a8) and m < _CARD_MIN_ROWS:
        a8 = F.pad(a8, (0, 0, 0, _CARD_PAD_ROWS - m))
    return int8_matmul(a8.contiguous(), weight.padded)[:m, : weight.scale.shape[0]]


def dense_int8(weight: Int8Weight, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W8A8 product of ``x`` (..., K) with per-token activation scales, in ``dtype``.

    ``ser_tpu``'s ``_dense_int8`` and ``QuantDense`` numerics: int32
    accumulator, ``acc * (ascale * wscale)`` in float32, the bias added in
    float32, then the cast.
    """
    a8, ascale = quantize_rows(x)
    lead = a8.shape[:-1]
    acc = int8_product(a8.reshape(-1, a8.shape[-1]), weight).reshape(*lead, -1)
    out = acc.to(torch.float32) * (ascale * weight.scale)
    if weight.bias is not None:
        out = out + weight.bias.to(torch.float32)
    return out.to(dtype)


class QuantDense(nn.Linear):
    """``nn.Linear`` with a W8A8 int8 product (``ser_tpu``'s ``QuantDense``).

    Its state dict is ``nn.Linear``'s (``weight`` (out, in), ``bias``), so the
    converter and the checkpoints are shared with the bf16 encoder. Call it
    with the compute dtype of its output: ``layer(x, dtype)``.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, **kwargs) -> None:
        super().__init__(in_features, out_features, bias=bias, **kwargs)
        self._quantized: Int8Weight | None = None
        self._quantized_key: tuple | None = None

    def _weight_key(self) -> tuple:
        weight = self.weight
        try:
            version = weight._version
        except RuntimeError:  # inference tensors keep no version counter
            version = None
        return weight.data_ptr(), weight.device, weight.dtype, version

    @torch.no_grad()
    def quantized(self) -> Int8Weight:
        """The int8 weights and scales, computed once per weight tensor."""
        key = self._weight_key()
        if self._quantized is None or self._quantized_key != key:
            self._quantized = Int8Weight(self.weight.detach().t(), self.bias)
            self._quantized_key = key
        return self._quantized

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        return dense_int8(self.quantized(), x, dtype or self.weight.dtype)


__all__ = [
    "Int8Weight",
    "QuantDense",
    "dense_int8",
    "int8_matmul",
    "int8_product",
    "quantize_columns",
    "quantize_rows",
]
