"""Exact GELU of the PyTorch port against the JAX package's polynomial GELU.

``ser_tpu.ops.activations.gelu_erf`` evaluates erf with a Chebyshev
polynomial whose documented error is 9.5e-7; the port uses PyTorch's exact
``F.gelu(approximate="none")``. Since gelu(x) = x (1 + erf(x / sqrt 2)) / 2,
an erf error e moves the output by |x| e / 2: on the same float32 inputs they
agree to 1e-6 max(1, |x|).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops.activations import gelu_erf as jax_gelu_erf
from ser_tpu_torch.ops.activations import gelu_erf


@pytest.mark.parametrize(
    "x",
    [
        np.random.default_rng(0).standard_normal(50_000).astype(np.float32) * 3.0,
        np.linspace(-12.0, 12.0, 20_001, dtype=np.float32),
        np.array([0.0, -0.0, 1e-30, -1e-30, 6.0, -6.0], dtype=np.float32),
    ],
    ids=["normal", "sweep", "edges"],
)
def test_gelu_matches_jax_polynomial(x: np.ndarray) -> None:
    ours = gelu_erf(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_gelu_erf(jnp.asarray(x)))
    excess = np.abs(ours - ref) - 1e-6 * np.maximum(1.0, np.abs(x))
    assert excess.max() <= 0.0, f"x={x[excess.argmax()]}: {np.abs(ours - ref).max()}"


def test_gelu_keeps_dtype() -> None:
    x = torch.linspace(-4.0, 4.0, 64, dtype=torch.bfloat16)
    assert gelu_erf(x).dtype == torch.bfloat16
