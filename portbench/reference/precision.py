"""The control's lower precision: W8A8 int8 products.

Symmetric int8 with one scale per output channel of the weight and one per token of the
activation (each its abs-max over 127), rounded half to even, an exact integer sum, then
the dequantized float32 result plus the bias. The step below bf16 that would tempt a
later change; put in the program's place it has to come out as not correct.
"""

from __future__ import annotations

import torch


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``F.linear`` through W8A8 int8: x (..., K), weight (N, K)."""
    w_scale = torch.clamp(weight.abs().amax(dim=1), min=1e-8) / 127.0
    x_scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    w8 = torch.round(weight / w_scale[:, None]).double()
    x8 = torch.round(x / x_scale).double()
    out = ((x8 @ w8.T) * (x_scale.double() * w_scale.double())).float()
    return out if bias is None else out + bias

