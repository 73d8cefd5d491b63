"""K4 and K5's split over a thread-block cluster, emulated in PyTorch on the CPU.

The kernels (``ser_tpu_torch/csrc/decode_step.cu``) cut the keys of each head
into one chunk per CTA and combine the CTAs' results in a fixed order. This
file repeats that order in PyTorch for a given cluster size: chunk boundaries
from the wrapper's own helper (``chunk_bounds``), each chunk's max and sum of
exp combined in rank order, P normalised in float32 before its rounding to the
compute dtype, the P·V and (K5) Q-projection partials summed in rank order, and
the per-head out-projection partials summed in head order. The emulation is
held to the plain versions and to the Pallas kernels in interpret mode, in
float32 at tiny shapes, at the JAX package's tolerance (2e-4), with chunk
layouts that leave one CTA a short chunk and another none.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import decode_step_kernels as jax_dsk
from ser_tpu_torch.ops import decode_step_kernels as dsk
from ser_tpu_torch.ops import kernel_build

R, H, DH = 2, 2, 4
D = 16
SMAX = 24
EPS = 1e-5
TOL = 2e-4


def _draw(seed: int, *shapes) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _split_attend(q, k, v, n_keys: int, cluster: int):
    """The kernels' attention over keys [0, n_keys): per-CTA chunks, (max, sum)
    combined in rank order, P normalised then rounded, P·V partials in rank order.

    q (R, H, Dh); k (R, H, Dh, S); v (R, H, S, Dh). Returns the head outputs
    (R, H, Dh) in q's dtype and the float32 weights (R, H, n_keys).
    """
    cdt = q.dtype
    root = dsk.root_d(q.shape[-1], cdt)
    chunks = []
    for start, stop in dsk.chunk_bounds(n_keys, cluster):
        scores = torch.einsum("rhd,rhds->rhs", q, k[..., start:stop]).to(cdt) / root
        scores = scores.to(torch.float32)
        if stop > start:
            m = scores.amax(dim=-1)
            l = torch.exp(scores - m[..., None]).sum(dim=-1)
        else:
            m = torch.full(q.shape[:2], -torch.inf)
            l = torch.zeros(q.shape[:2])
        chunks.append((start, stop, scores, m, l))
    big_m = chunks[0][3]
    for _, _, _, m, _ in chunks[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(big_m)
    for start, stop, _, m, l in chunks:
        if stop > start:  # an empty chunk adds nothing, and exp(-inf - M) is never formed
            big_l = big_l + l * torch.exp(m - big_m)
    weights, pv = [], None
    for start, stop, scores, _, _ in chunks:
        p = torch.exp(scores - big_m[..., None]) / big_l[..., None]
        weights.append(p)
        part = torch.einsum("rhs,rhsd->rhd", p.to(cdt).to(torch.float32), v[:, :, start:stop].to(torch.float32))
        pv = part if pv is None else pv + part
    return pv.to(cdt), torch.cat(weights, dim=-1)


def _split_out_project(heads_out, w_out, b_out, x_residual):
    """Per-head float32 partials of the out-projection, summed in head order."""
    acc = None
    for h in range(w_out.shape[0]):
        part = heads_out[:, h].to(torch.float32) @ w_out[h].to(torch.float32)
        acc = part if acc is None else acc + part
    return x_residual + (acc.to(x_residual.dtype) + b_out)


def _split_self_attend(q, k, v, w_out, b_out, x, position: int, cluster: int):
    heads_out, _ = _split_attend(q, k, v, position + 1, cluster)
    return _split_out_project(heads_out, w_out, b_out, x)


def _split_cross_step(x, ln_scale, ln_bias, w_q, b_q, k, v, w_out, b_out, *, cluster: int):
    """K5: the Q projection's d-slice partials summed in rank order, then attention."""
    cdt = x.dtype
    h = dsk.ln_f32(x, ln_scale, ln_bias, EPS).to(cdt)
    d = x.shape[1]
    slice_width = d // cluster
    q_acc = None
    for rank in range(cluster):
        cols = slice(rank * slice_width, (rank + 1) * slice_width)
        part = torch.einsum("rk,hke->rhe", h[:, cols].to(torch.float32), w_q[:, cols].to(torch.float32))
        q_acc = part if q_acc is None else q_acc + part
    q = q_acc.to(cdt) + b_q[:, 0]
    heads_out, weights = _split_attend(q, k, v, k.shape[-1], cluster)
    return _split_out_project(heads_out, w_out, b_out, x), weights.transpose(0, 1)


def _self_args(seed: int = 1):
    return _draw(seed, (R, H, DH), (R, H, DH, SMAX), (R, H, SMAX, DH), (H, DH, D), (1, D), (R, D))


def _poisoned(k: np.ndarray, v: np.ndarray, position: int):
    k_p, v_p = k.copy(), v.copy()
    k_p[..., position + 1 :] = 1e4
    v_p[:, :, position + 1 :, :] = -1e4
    return k_p, v_p


def test_chunk_bounds_cover_the_keys_in_aligned_chunks() -> None:
    for n_keys in range(1, 60):
        for cluster in (1, 2, 4, 8):
            bounds = dsk.chunk_bounds(n_keys, cluster)
            chunk = dsk.chunk_keys(n_keys, cluster)
            assert chunk % 4 == 0 and chunk * cluster >= n_keys
            assert bounds[0][0] == 0 and bounds[-1][1] == n_keys
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert all(start % 4 == 0 for start, stop in bounds if stop > start)


# (position, cluster): position 0 (one key, every other CTA empty); the last key
# of a chunk (7 with 4 CTAs: chunks of 4, the third and fourth empty); the first
# key of the next chunk (8: the third CTA has one key); SMAX - 1 (24 keys over 8
# CTAs of 4: the last two empty; over 4 CTAs of 8: the last empty).
SELF_CASES = [(0, 4), (7, 4), (8, 4), (SMAX - 1, 8), (SMAX - 1, 4), (13, 2)]


@pytest.mark.parametrize(("position", "cluster"), SELF_CASES)
def test_split_self_attend_matches_plain_and_pallas(position: int, cluster: int) -> None:
    q, k, v, w_out, b_out, x = _self_args()
    k_p, v_p = _poisoned(k, v, position)
    split = _split_self_attend(*_t(q, k_p, v_p, w_out, b_out, x), position, cluster)
    plain = dsk.self_attend_and_out_reference(*_t(q, k, v, w_out, b_out, x), position)
    pallas = np.asarray(
        jax_dsk.self_attend_and_out(*_j(q, k, v, w_out, b_out, x), jnp.asarray(position, dtype=jnp.int32))
    )
    np.testing.assert_allclose(split.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split.numpy(), pallas, rtol=TOL, atol=TOL)
    # Poisoned future slots do not move the emulation.
    clean = _split_self_attend(*_t(q, k, v, w_out, b_out, x), position, cluster)
    np.testing.assert_allclose(split.numpy(), clean.numpy(), rtol=1e-6, atol=1e-6)


def test_self_cases_cover_the_chunk_edges() -> None:
    def chunk_of(position, cluster):
        return next((a, b) for a, b in dsk.chunk_bounds(position + 1, cluster) if a <= position < b)

    # 7 over 4 CTAs: the last key of the chunk [4, 8), two CTAs without keys after it.
    assert chunk_of(7, 4) == (4, 8) and dsk.chunk_bounds(8, 4)[2:] == [(8, 8), (8, 8)]
    # 8 over 4 CTAs: the first key of the next chunk, which is short (one key).
    assert chunk_of(8, 4) == (8, 9)
    assert chunk_of(0, 4) == (0, 1) and chunk_of(SMAX - 1, 8) == (20, 24)


# S = 20 over 4 CTAs: chunks of 8, 8, 4 (short) and none; over 8: 4 each, the last three empty.
@pytest.mark.parametrize(("s_len", "cluster"), [(20, 4), (20, 8), (12, 2), (16, 1)])
def test_split_cross_step_matches_plain_and_pallas(s_len: int, cluster: int) -> None:
    arrays = _draw(2, (R, D), (1, D), (1, D), (H, D, DH), (H, 1, DH), (R, H, DH, s_len), (R, H, s_len, DH),
                   (H, DH, D), (1, D))
    split_x, split_w = _split_cross_step(*_t(*arrays), cluster=cluster)
    plain_x, plain_w = dsk.cross_attention_step_reference(*_t(*arrays), eps=EPS)
    pallas_x, pallas_w = jax_dsk.cross_attention_step(*_j(*arrays), eps=EPS)
    assert tuple(split_w.shape) == (H, R, s_len)
    np.testing.assert_allclose(split_x.numpy(), plain_x.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split_w.numpy(), plain_w.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split_x.numpy(), np.asarray(pallas_x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split_w.numpy(), np.asarray(pallas_w), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(split_w.sum(dim=-1).numpy(), 1.0, rtol=1e-5, atol=1e-5)


def test_split_in_bf16_stays_near_the_float32_plain_version() -> None:
    """The emulation in bf16 (the kernels' working type) against the float32 plain version."""
    position, cluster = SMAX - 1, 8
    args = _t(*_self_args(3))
    split = _split_self_attend(*(a.to(torch.bfloat16) for a in args), position, cluster)
    plain = dsk.self_attend_and_out_reference(*(a.to(torch.bfloat16).float() for a in args), position)
    rel = ((split.float() - plain).norm() / plain.norm()).item()
    assert rel < 1e-2


def test_wrapper_constants_follow_the_kernel_source() -> None:
    source = (kernel_build.CSRC_DIR / "decode_step.cu").read_text(encoding="utf-8")
    (max_cluster,) = re.findall(r"constexpr int kMaxCluster = (\d+);", source)
    (key_align,) = re.findall(r"constexpr int kKeyAlign = (\d+);", source)
    assert dsk._MAX_CLUSTER == int(max_cluster) <= 8
    assert dsk._KEY_ALIGN == int(key_align)
    # The chunk rule: the C expression, evaluated in Python, against the wrapper's helper.
    (expression,) = re.findall(r"constexpr int chunk_keys\(int n_keys, int cluster\) \{\s*return ([^;]+);", source)
    python_expression = expression.replace("/", "//")
    for n_keys in (1, 4, 5, 100, 447, 448, 1500):
        for cluster in (1, 2, 4, 8):
            namespace = {"n_keys": n_keys, "cluster": cluster, "kKeyAlign": int(key_align)}
            assert eval(python_expression, {}, namespace) == dsk.chunk_keys(n_keys, cluster)


def test_wrappers_refuse_key_counts_off_the_alignment_rule() -> None:
    """K's chunks are loaded 4 keys (8 bytes) at a time: S and Smax must be multiples of 4."""
    rows, heads, dh, d, s_len = 2, 2, 64, 128, 6

    def meta(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16, device="meta")

    with pytest.raises(ValueError, match="multiple of 4"):
        dsk.cross_attention_step(meta(rows, d), meta(1, d), meta(1, d), meta(heads, d, dh), meta(heads, 1, dh),
                                 meta(rows, heads, dh, s_len), meta(rows, heads, s_len, dh), meta(heads, dh, d),
                                 meta(1, d), eps=EPS)
    with pytest.raises(ValueError, match="multiple of 4"):
        dsk.self_attend_and_out(meta(rows, heads, dh), meta(rows, heads, dh, s_len), meta(rows, heads, s_len, dh),
                                meta(heads, dh, d), meta(1, d), meta(rows, d), 2)
