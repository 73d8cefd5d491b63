"""Decode-step kernels K3, K4 and K5: the port's plain versions against the Pallas kernels.

On the CPU each wrapper runs its plain version; ``ser_tpu``'s kernels run in
Pallas interpret mode, as its own tests run them. Same numpy-seeded float32
inputs on both sides; the tolerances and the two extra pins are the JAX
package's (``tests/suites/unit/ops/test_decode_step_kernels.py``): poisoned
future cache slots do not move K4's output, and K5's weights sum to 1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import decode_step_kernels as jax_dsk
from ser_tpu_torch.ops import decode_step_kernels as dsk

R, H, DH, SMAX, S = 2, 2, 4, 8, 6
D = H * DH
EPS = 1e-5


def _draw(seed: int, *shapes) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_ln_qkv_project_matches_pallas() -> None:
    arrays = _draw(0, (R, D), (1, D), (1, D), (D, 3 * D), (1, 3 * D))
    ref = np.asarray(jax_dsk.ln_qkv_project(*_j(*arrays), eps=EPS))
    ours = dsk.ln_qkv_project(*_t(*arrays), eps=EPS)
    assert ours.shape == (R, 3 * D) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("position", [0, 3, SMAX - 1])
def test_self_attend_and_out_matches_pallas(position: int) -> None:
    q, k, v, w_out, b_out, x_res = _draw(1, (R, H, DH), (R, H, DH, SMAX), (R, H, SMAX, DH), (H, DH, D), (1, D), (R, D))
    ref = np.asarray(
        jax_dsk.self_attend_and_out(*_j(q, k, v, w_out, b_out, x_res), jnp.asarray(position, dtype=jnp.int32))
    )
    ours = dsk.self_attend_and_out(*_t(q, k, v, w_out, b_out, x_res), position)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-4)

    # Poisoned masked cache slots must not change the output.
    k_poison, v_poison = k.copy(), v.copy()
    k_poison[..., position + 1 :] = 1e4
    v_poison[:, :, position + 1 :, :] = -1e4
    poisoned = dsk.self_attend_and_out(*_t(q, k_poison, v_poison, w_out, b_out, x_res), position)
    np.testing.assert_allclose(poisoned.numpy(), ours.numpy(), rtol=1e-6, atol=1e-6)


def test_cross_attention_step_matches_pallas_and_weights_sum_to_one() -> None:
    arrays = _draw(2, (R, D), (1, D), (1, D), (H, D, DH), (H, 1, DH), (R, H, DH, S), (R, H, S, DH), (H, DH, D), (1, D))
    ref_x, ref_w = jax_dsk.cross_attention_step(*_j(*arrays), eps=EPS)
    ours_x, ours_w = dsk.cross_attention_step(*_t(*arrays), eps=EPS)
    assert tuple(ours_w.shape) == (H, R, S) and ours_w.dtype == torch.float32
    np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours_w.numpy(), np.asarray(ref_w), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours_w.sum(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_per_head_layouts_match_jax() -> None:
    w_q, b_q, w_out = _draw(3, (D, D), (D,), (D, D))
    ref_w, ref_b = jax_dsk.per_head_q_proj(jnp.asarray(w_q), jnp.asarray(b_q), H)
    ours_w, ours_b = dsk.per_head_q_proj(torch.from_numpy(w_q), torch.from_numpy(b_q), H)
    np.testing.assert_array_equal(ours_w.numpy(), np.asarray(ref_w))
    np.testing.assert_array_equal(ours_b.numpy(), np.asarray(ref_b))
    np.testing.assert_array_equal(
        dsk.per_head_out_proj(torch.from_numpy(w_out), H).numpy(),
        np.asarray(jax_dsk.per_head_out_proj(jnp.asarray(w_out), H)),
    )


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch() -> None:
    before = [counter.launches for counter in dsk.COUNTERS]
    arrays = _draw(4, (R, D), (1, D), (1, D), (D, 3 * D), (1, 3 * D))
    dsk.ln_qkv_project(*_t(*arrays), eps=EPS)
    assert [counter.launches for counter in dsk.COUNTERS] == before


def test_non_cpu_tensors_take_the_kernel_path_and_never_fall_back() -> None:
    """A tensor that is not on the CPU goes to the kernel's checks, which raise
    on what the kernel does not take, instead of running the plain version."""
    arrays = [torch.from_numpy(a).to("meta") for a in _draw(5, (R, D), (1, D), (1, D), (D, 3 * D), (1, 3 * D))]
    with pytest.raises(TypeError, match="bfloat16"):
        dsk.ln_qkv_project(*arrays, eps=EPS)
    q, k, v, w_out, b_out, x_res = (
        torch.from_numpy(a).to("meta") for a in _draw(6, (R, H, DH), (R, H, DH, SMAX), (R, H, SMAX, DH), (H, DH, D), (1, D), (R, D))
    )
    with pytest.raises(TypeError, match="bfloat16"):
        dsk.self_attend_and_out(q, k, v, w_out, b_out, x_res, 2)
