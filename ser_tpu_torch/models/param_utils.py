"""State-dict utilities shared by the model families.

Counterpart of ``ser_tpu/models/param_utils.py``.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch


def cast_state_bf16(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Floating tensors → bfloat16 storage; integer and bool tensors untouched.

    Counterpart of ``cast_params_bf16``: for inference with a bf16 compute
    policy, storing the weights in bf16 halves their device memory, and the
    products that cast them to bf16 anyway see the same values. The float32
    parts of the forward (LayerNorms, the wav2vec2 front end) see bf16-rounded
    weights, within the bf16 policy's error.
    """
    return {
        name: tensor.to(torch.bfloat16) if tensor.is_floating_point() else tensor for name, tensor in state.items()
    }


__all__ = ["cast_state_bf16"]
