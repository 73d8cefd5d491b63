"""Attention of the PyTorch port against ``ser_tpu.models.attention`` on the CPU.

On the CPU both packages take their plain path (the einsum reference), held
at atol 2e-5 with and without a frame mask, as the JAX package's own tests
pin it (``tests/suites/unit/models/test_attention.py``). Kernel K2 itself runs
only on the card and is held against this plain version by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import attention as jax_attention
from ser_tpu_torch.models import attention

ATOL = 2e-5


@pytest.fixture()
def qkv() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(7)
    shape = (2, 9, 3, 8)  # (B, T, H, D)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _mask(valid: int) -> np.ndarray:
    mask = np.ones((2, 9), dtype=bool)
    mask[1, valid:] = False
    return mask


def _ours(q, k, v, mask=None) -> np.ndarray:
    out = attention.multi_head_attention(
        torch.from_numpy(q),
        torch.from_numpy(k),
        torch.from_numpy(v),
        frame_mask=None if mask is None else torch.from_numpy(mask),
    )
    return out.numpy()


def _jax(q, k, v, mask=None) -> np.ndarray:
    out = jax_attention.multi_head_attention(
        jnp.asarray(q),
        jnp.asarray(k),
        jnp.asarray(v),
        frame_mask=None if mask is None else jnp.asarray(mask),
    )
    return np.asarray(out)


@pytest.mark.parametrize("valid", [None, 6, 1])
def test_matches_jax_attention(qkv, valid) -> None:
    mask = None if valid is None else _mask(valid)
    np.testing.assert_allclose(_ours(*qkv, mask), _jax(*qkv, mask), atol=ATOL)


def test_masked_keys_cannot_influence_valid_queries(qkv) -> None:
    q, k, v = qkv
    mask = _mask(7)
    base = _ours(q, k, v, mask)
    k2, v2 = k.copy(), v.copy()
    k2[1, 7:] += 100.0
    v2[1, 7:] -= 100.0
    np.testing.assert_allclose(_ours(q, k2, v2, mask)[1, :7], base[1, :7], atol=1e-6)


def test_output_keeps_dtype_and_layout(qkv) -> None:
    out = attention.multi_head_attention(*(torch.from_numpy(t) for t in qkv))
    assert out.shape == qkv[0].shape
    assert out.dtype == torch.float32


def test_cpu_path_launches_no_kernel(qkv) -> None:
    before = attention.COUNTER.launches
    _ours(*qkv)
    assert attention.COUNTER.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(qkv) -> None:
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in qkv)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention(q, k, v)
