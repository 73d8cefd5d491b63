"""Exact (erf) GELU.

Counterpart of ``ser_tpu/ops/activations.py``. The JAX package evaluates erf
as a degree-14 Chebyshev polynomial in float32 (documented max error 9.5e-7
in erf); here it is PyTorch's exact GELU, which computes in float32 for bf16
inputs and rounds once, as the polynomial does. The two agree within
1e-6 max(1, |x|) on finite inputs; at x = +inf PyTorch gives NaN where the
polynomial gives +inf. It is an elementwise op outside any TPU kernel, so it
has no kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu_erf"]


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU; same dtype out as in."""
    return F.gelu(x, approximate="none")
