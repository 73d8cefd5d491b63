"""K2-f32's arithmetic and layouts, emulated on the CPU.

Kernel K2-f32 (``ser_tpu_torch/csrc/flash_attention_f32.cu``) forms every
float32 product on the tensor cores as three TF32 products of split operands:
x = hi + lo, hi = x rounded to TF32 (``cvt.rna``), lo = (x − hi) rounded to
TF32, and x·y = lo_x·hi_y + hi_x·lo_y + hi_x·hi_y. This file repeats that
arithmetic in PyTorch (q prescaled by log2(e)/√D, scores in log2 units, P split
after the exponentials) and holds it to the float32 plain version and to
``ser_tpu``'s attention at the port's float32 limit (max abs 2e-5), at a small
size and at the medium profile's T = 1499, while the one-pass TF32 and the
dropped-cross-term variants stay above that limit. It also checks the
kernel's index maps: the permutation of keys inside each 8-key group that
makes the score accumulator's registers the P operand's A fragments, the
transposing copy of V that applies it, and the tile constants that the
wrapper's mask padding relies on.
"""

from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import attention as jax_attention
from ser_tpu_torch.models import attention
from ser_tpu_torch.ops import kernel_build

LIMIT = 2e-5  # the port's float32 attention pin (tests/test_torch_attention.py)
LOG2E = 1.4426950408889634
SOURCE = (kernel_build.CSRC_DIR / "flash_attention_f32.cu").read_text(encoding="utf-8")


def _constant(name: str) -> int:
    match = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert match, f"{name} not found in flash_attention_f32.cu"
    return int(match.group(1))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(equation: str, x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    """One T×T×D product as the kernel forms it ("split"), as one TF32 pass
    ("tf32"), or with the lo_x·hi_y term left out ("dropped")."""
    if mode == "tf32":
        return torch.einsum(equation, _tf32(x), _tf32(y))
    x_hi, x_lo = _split(x)
    y_hi, y_lo = _split(y)
    total = torch.einsum(equation, x_hi, y_lo) + torch.einsum(equation, x_hi, y_hi)
    if mode == "split":
        total = torch.einsum(equation, x_lo, y_hi) + total
    return total


def _emulate(q, k, v, frame_mask=None, mode: str = "split") -> torch.Tensor:
    """K2-f32's arithmetic on (B, T, H, D) float32 tensors."""
    q_scaled = q * (LOG2E / math.sqrt(q.shape[-1]))
    scores = _product("bqhd,bkhd->bhqk", q_scaled, k, mode)  # log2 units
    if frame_mask is not None:
        scores = torch.where(frame_mask[:, None, None, :], scores, torch.tensor(-1e30))
    p = torch.exp2(scores - scores.amax(dim=-1, keepdim=True))
    return _product("bhqk,bkhd->bqhd", p, v, mode) / p.sum(dim=-1).transpose(1, 2)[..., None]


def _inputs(seed: int, shape, step: int | None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = None
    if step is not None:
        batch, seq = shape[:2]
        lengths = np.array([seq - step * i for i in range(batch)])
        mask = np.arange(seq)[None, :] < lengths[:, None]
    return q, k, v, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("step", [None, 4])
def test_split_matches_plain_and_jax_at_a_small_size(step) -> None:
    q, k, v, mask = _inputs(0, (2, 37, 3, 64), step)
    tq, tk, tv, tmask = _torch(q, k, v, mask)
    ours = _emulate(tq, tk, tv, tmask)
    plain = attention.attention_reference(tq, tk, tv, frame_mask=tmask)
    jax_out = np.asarray(jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), frame_mask=None if mask is None else jnp.asarray(mask)
    ))
    valid = slice(None) if mask is None else torch.from_numpy(mask)
    assert (ours - plain)[valid].abs().max().item() <= LIMIT
    assert np.abs(ours.numpy() - jax_out)[valid.numpy() if mask is not None else valid].max() <= LIMIT


def test_split_holds_and_faults_are_caught_at_the_medium_length() -> None:
    q, k, v, mask = _torch(*_inputs(1, (2, 1499, 2, 64), 150))
    plain = attention.attention_reference(q, k, v, frame_mask=mask)
    errors = {mode: (_emulate(q, k, v, mask, mode) - plain).abs().max().item() for mode in ("split", "tf32", "dropped")}
    assert errors["split"] <= LIMIT, errors
    assert errors["tf32"] > LIMIT and errors["dropped"] > LIMIT, errors


def test_split_is_exact_in_float32() -> None:
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32)) * 3.0
    hi, lo = _split(x)
    for part in (hi, lo):
        assert torch.equal(part.view(torch.int32) & 0x1FFF, torch.zeros_like(part, dtype=torch.int32))
    # hi + lo recovers x to about 2^-22 of its size: the dropped lo·lo term's scale.
    assert ((hi + lo - x).abs() <= x.abs() * 2.0**-21).all()


def _slot_key(kappa: int) -> int:
    """Key (inside its 8-key group) that the kernel stores in k-slot ``kappa`` of V^T."""
    return 2 * kappa if kappa < 4 else 2 * (kappa - 4) + 1


def test_key_permutation_is_a_bijection_the_fragments_undo() -> None:
    assert sorted(_slot_key(kappa) for kappa in range(8)) == list(range(8))
    # The S accumulator gives thread t4 keys 2 t4 and 2 t4 + 1 of each group; the TF32
    # A fragment takes k-slots t4 and t4 + 4. With the permutation they are the same keys.
    for t4 in range(4):
        assert (_slot_key(t4), _slot_key(t4 + 4)) == (2 * t4, 2 * t4 + 1)
    # P·V through the permuted V^T tile equals P·V.
    rng = np.random.default_rng(3)
    p = rng.standard_normal((16, 64))
    vt_perm = np.empty((64, 64))
    v = rng.standard_normal((64, 64))  # (keys, D)
    for slot in range(64):
        vt_perm[:, slot] = v[8 * (slot // 8) + _slot_key(slot % 8)]
    p_perm = np.empty_like(p)  # P's columns in slot order, as the fragments hold them
    for slot in range(64):
        p_perm[:, slot] = p[:, 8 * (slot // 8) + _slot_key(slot % 8)]
    np.testing.assert_allclose(p_perm @ vt_perm.T, p @ v, rtol=1e-12, atol=1e-12)


def _v_transpose_blocks():
    """The split warps' copy of a 64-key × 64-dim V tile into V^T (``split_tile``): for
    block ``blk``, its (key, d) reads and (d, slot) writes, with the 16-byte chunk of a
    128-byte swizzled row that each touches, per row of the 4 × 4 block."""
    for blk in range(64 * 64 // 16):
        l, x, d_half, k_half = blk & 7, (blk >> 3) & 7, (blk >> 6) & 1, blk >> 7
        dc = (l & 6) ^ x
        group = 4 * k_half + (l >> 1)
        keys = [8 * group + 2 * m + (l & 1) for m in range(4)]
        reads = [(key, 32 * d_half + 4 * dc, dc ^ (key & 7)) for key in keys]
        writes = []
        for i in range(4):
            d = 32 * d_half + 4 * dc + i
            writes.append((d, 32 * k_half + 4 * l, l ^ (d & 7)))
        yield blk, keys, reads, writes


def test_v_transpose_writes_every_slot_once_with_the_permutation() -> None:
    seen = {}
    for _, keys, reads, writes in _v_transpose_blocks():
        for d, slot0, _ in writes:
            for m in range(4):
                slot = slot0 + m
                assert (d, slot) not in seen
                seen[(d, slot)] = keys[m]
                assert keys[m] == 8 * (slot // 8) + _slot_key(slot % 8)
        assert {r[1] for r in reads} == {w[0] - w[0] % 4 for w in writes}
    assert len(seen) == 64 * 64


def test_v_transpose_quarter_warps_touch_distinct_bank_groups() -> None:
    blocks = list(_v_transpose_blocks())
    for start in range(0, len(blocks), 8):  # 8 consecutive threads: one quarter-warp
        quarter = blocks[start : start + 8]
        for i in range(4):
            assert len({reads[i][2] for _, _, reads, _ in quarter}) == 8
            assert len({writes[i][2] for _, _, _, writes in quarter}) == 8


def test_tile_constants_agree_with_the_wrapper() -> None:
    block_k = _constant("kBlockK")
    assert _constant("kBlockQ") % 64 == 0  # 64 queries per consumer warpgroup
    # The wrapper pads the mask rows to attention._TILE; the source takes any stride that
    # is at least T rounded up to kBlockK and a multiple of 16.
    assert attention._TILE % block_k == 0 and attention._TILE % 16 == 0
    assert re.search(r"padded = \(seq \+ kBlockK - 1\) / kBlockK \* kBlockK;", SOURCE)
    assert re.search(r"mask_stride < padded \|\| mask_stride % 16 != 0", SOURCE)
    for seq in (1, 63, 64, 65, 749, 1409, 1499, 1500):
        stride = attention._padded_len(seq)
        assert stride >= -(-seq // block_k) * block_k and stride % 16 == 0
    # Each key tile's mask bytes arrive in one aligned bulk copy.
    assert block_k % 16 == 0


def test_ablation_copies_find_their_anchors() -> None:
    """Each part that ``scripts/flash_attention_f32_ablation.py`` takes out is in the source once."""
    from ser_tpu_torch.scripts import flash_attention_f32_ablation as ablation

    for _name, edits in ablation.COPIES:
        for anchor, _replacement in edits:
            assert SOURCE.count(anchor) == 1, anchor
