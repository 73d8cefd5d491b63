"""The attention backward of the PyTorch port against autograd and ``jax.vjp``, on the CPU.

``attention_backward_reference`` (the plain version of kernel K2-bwd) is held
at atol 1e-5 against PyTorch's autograd of ``attention_reference`` and against
``jax.vjp`` of ``ser_tpu.models.attention._einsum_path``, in float32, the JAX
package's own CPU route. ``FlashAttention``'s CPU route passes
``torch.autograd.gradcheck`` in float64. K2-bwd itself runs only on the card
and is held against this plain version by ``chip_smoke.py`` (phase K2-bwd).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import attention as jax_attention
from ser_tpu_torch.models import attention
from ser_tpu_torch.ops import kernel_build

ATOL = 1e-5
SHAPES = [(2, 37, 4, 64), (1, 130, 2, 64)]


def _inputs(shape, seed=11):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(4))


def _reference_grads(q, k, v, dout):
    q, k, v, dout = (torch.from_numpy(t) for t in (q, k, v, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = attention.attention_with_lse_reference(q, k, v, scale)
    return attention.attention_backward_reference(q, k, v, out, lse, dout, scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_autograd(shape) -> None:
    q, k, v, dout = _inputs(shape)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = attention.attention_reference(*leaves)
    expected = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for ours, ref in zip(_reference_grads(q, k, v, dout), expected):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_jax_vjp(shape) -> None:
    q, k, v, dout = _inputs(shape)

    def einsum_path(q, k, v):
        return jax_attention._einsum_path(q, k, v, frame_mask=None, compute_dtype=jnp.float32)

    _, vjp = jax.vjp(einsum_path, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    expected = vjp(jnp.asarray(dout))
    for ours, ref in zip(_reference_grads(q, k, v, dout), expected):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_lse_is_logsumexp_of_scaled_scores() -> None:
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs((2, 37, 4, 64)))
    out, lse = attention.attention_with_lse_reference(q, k, v, 0.125)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), attention.attention_reference(q, k, v).numpy(), atol=ATOL)


def test_flash_attention_function_passes_gradcheck_in_float64() -> None:
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 8))).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: attention.FlashAttention.apply(a, b, c), (q, k, v))


def test_flash_attention_function_cpu_route_matches_plain_autograd() -> None:
    q, k, v, dout = _inputs((2, 37, 4, 64))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = attention.FlashAttention.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    plain = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    expected = torch.autograd.grad(attention.attention_reference(*plain), plain, torch.from_numpy(dout))
    for ours, ref in zip(grads, expected):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)


def test_masked_attention_with_grad_raises() -> None:
    q, k, v, _ = (torch.from_numpy(t).requires_grad_() for t in _inputs((2, 9, 3, 64)))
    mask = torch.ones((2, 9), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="masked attention"):
        attention.FlashAttention.apply(q, k, v, mask)
    q, k, v = (t.detach() for t in (q, k, v))
    out = attention.FlashAttention.apply(q, k, v, mask)  # without a gradient the masked forward runs
    np.testing.assert_allclose(
        out.numpy(), attention.attention_reference(q, k, v, frame_mask=mask).numpy(), atol=ATOL
    )


def test_cpu_multi_head_attention_keeps_the_plain_forward_under_grad() -> None:
    q, k, v, dout = _inputs((1, 130, 2, 64))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = attention.multi_head_attention(*leaves)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for ours, ref in zip(grads, _reference_grads(q, k, v, dout)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("seq", [37, 64, 1500])
def test_padded_lse_layout(seq) -> None:
    lse = torch.randn(2, 3, seq)
    padded = attention._padded_lse(lse, 2, 3, seq)
    width = -(-seq // 64) * 64
    assert padded.stride() == (3 * width, width, 1)
    assert torch.equal(padded, lse)
    assert attention._padded_lse(padded, 2, 3, seq) is padded


def test_refuse_grad_only_in_grad_mode() -> None:
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel_build.refuse_grad("a kernel", torch.zeros(3), x)
    with torch.no_grad():
        kernel_build.refuse_grad("a kernel", x)
    kernel_build.refuse_grad("a kernel", x.detach())
