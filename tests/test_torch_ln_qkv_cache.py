"""K3's cache-writing form on the CPU: its plain version against today's scatters and ``ser_tpu``.

``ln_qkv_project_to_cache`` returns q and writes the K and V parts of K3's output
into the self-attention caches at ``position`` (on the card the kernel does
both). On the CPU it takes its plain version, which must equal
``ln_qkv_project`` followed by the decode step's two scatters, bit for bit, and
touch no other cache slot. Against ``ser_tpu``'s ``ln_qkv_project`` (Pallas
interpret mode) on the same numpy-seeded float32 inputs it holds at the
tolerance ``tests/test_torch_decode_step_kernels.py`` pins for K3 (2e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import decode_step_kernels as jax_dsk
from ser_tpu_torch.ops import decode_step_kernels as dsk

R, H, DH, SMAX = 2, 2, 64, 8
D = H * DH
EPS = 1e-5


def _draw(seed: int):
    rng = np.random.default_rng(seed)
    shapes = ((R, D), (1, D), (1, D), (D, 3 * D), (1, 3 * D), (R, H, DH, SMAX), (R, H, SMAX, DH))
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _scattered(x, scale, bias, w, b, k_cache, v_cache, position: int):
    """The fused decode step's cache update before K3 wrote it: the projection, then two scatters."""
    qkv = dsk.ln_qkv_project(x, scale, bias, w, b, eps=EPS)
    k_cache[:, :, :, position] = qkv[:, D : 2 * D].reshape(R, H, -1)
    v_cache[:, :, position, :] = qkv[:, 2 * D :].reshape(R, H, -1)
    return qkv[:, :D]


@pytest.mark.parametrize("position", [0, 3, SMAX - 1])
def test_cache_form_equals_projection_and_scatters(position: int) -> None:
    x, scale, bias, w, b, k_cache, v_cache = (torch.from_numpy(a) for a in _draw(position))
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    q_ref = _scattered(x, scale, bias, w, b, k_ref, v_ref, position)
    q = dsk.ln_qkv_project_to_cache(x, scale, bias, w, b, k_cache, v_cache, position, eps=EPS)
    assert q.shape == (R, D)
    assert torch.equal(q, q_ref)
    assert torch.equal(k_cache, k_ref) and torch.equal(v_cache, v_ref)


@pytest.mark.parametrize("position", [0, SMAX - 1])
def test_cache_form_touches_only_the_position(position: int) -> None:
    x, scale, bias, w, b, k_cache, v_cache = (torch.from_numpy(a) for a in _draw(10 + position))
    k_before, v_before = k_cache.clone(), v_cache.clone()
    dsk.ln_qkv_project_to_cache(x, scale, bias, w, b, k_cache, v_cache, position, eps=EPS)
    others = torch.arange(SMAX) != position
    assert torch.equal(k_cache[..., others], k_before[..., others])
    assert torch.equal(v_cache[:, :, others, :], v_before[:, :, others, :])
    assert not torch.equal(k_cache[..., position], k_before[..., position])
    assert not torch.equal(v_cache[:, :, position, :], v_before[:, :, position, :])


@pytest.mark.parametrize("position", [0, 5])
def test_cache_form_matches_pallas(position: int) -> None:
    arrays = _draw(20 + position)
    ref = np.asarray(jax_dsk.ln_qkv_project(*(jnp.asarray(a) for a in arrays[:5]), eps=EPS))
    x, scale, bias, w, b, k_cache, v_cache = (torch.from_numpy(a.copy()) for a in arrays)
    q = dsk.ln_qkv_project_to_cache(x, scale, bias, w, b, k_cache, v_cache, position, eps=EPS)
    np.testing.assert_allclose(q.numpy(), ref[:, :D], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(k_cache[..., position].numpy(), ref[:, D : 2 * D].reshape(R, H, DH), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(v_cache[:, :, position, :].numpy(), ref[:, 2 * D :].reshape(R, H, DH), rtol=2e-5,
                               atol=2e-5)


def test_write_cache_columns_is_the_step_scatter() -> None:
    rng = np.random.default_rng(30)
    qkv = torch.from_numpy(rng.standard_normal((R, 3 * D)).astype(np.float32))
    k_cache, v_cache = torch.zeros(R, H, DH, SMAX), torch.zeros(R, H, SMAX, DH)
    q = dsk.write_cache_columns(qkv, k_cache, v_cache, 2)
    assert torch.equal(q, qkv[:, :D])
    assert torch.equal(k_cache[0, 1, :, 2], qkv[0, D + DH : 2 * D])
    assert torch.equal(v_cache[1, 0, 2, :], qkv[1, 2 * D : 2 * D + DH])
    assert k_cache.count_nonzero() == R * D and v_cache.count_nonzero() == R * D


def test_cache_form_counts_no_launch_on_the_cpu() -> None:
    before = dsk.LN_QKV_COUNTER.launches
    x, scale, bias, w, b, k_cache, v_cache = (torch.from_numpy(a) for a in _draw(40))
    dsk.ln_qkv_project_to_cache(x, scale, bias, w, b, k_cache, v_cache, 1, eps=EPS)
    assert dsk.LN_QKV_COUNTER.launches == before


def test_cache_form_takes_the_kernel_path_off_the_cpu() -> None:
    """A tensor that is not on the CPU goes to the kernel's checks, which raise on
    what the kernel does not take, instead of running the plain version."""
    arrays = [torch.from_numpy(a).to("meta") for a in _draw(50)]
    with pytest.raises(TypeError, match="bfloat16"):
        dsk.ln_qkv_project_to_cache(*arrays, 1, eps=EPS)


def test_timeline_stops_find_their_anchors() -> None:
    """Each stop of ``scripts/decode_step_timeline.py`` (K3's among them) is in the source once."""
    from ser_tpu_torch.ops import kernel_build
    from ser_tpu_torch.scripts import decode_step_timeline

    source = (kernel_build.CSRC_DIR / "decode_step.cu").read_text(encoding="utf-8")
    names = [name for name, _anchor, _replacement in decode_step_timeline.STOPS]
    assert {"k3_start", "k3_loads", "k3_ln", "k3_products"} <= set(names)
    for _name, anchor, _replacement in decode_step_timeline.STOPS:
        assert source.count(anchor) == 1, anchor
