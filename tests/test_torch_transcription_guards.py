"""``WhisperForTranscription`` refuses, at construction, what the card cannot run.

On a CUDA device the greedy decode steps through kernels K3-K5, which take
bf16 only and a few shape rules, with no other route on the card. The
constructor checks both before it builds any weight: a float32 model raises
the runtime policy's ``NotImplementedError`` naming K3-K5, and a shape that
K3-K5 refuse raises ``ValueError`` naming the rule. These tests pass
``device="cuda"`` on this GPU-less host and empty state dicts: building a
weight would fail otherwise, so the expected error shows that nothing was
built first. On the CPU, where the plain versions run, any shape is taken.
"""

from __future__ import annotations

import dataclasses

import pytest

from ser_tpu_torch.models import whisper
from ser_tpu_torch.models.whisper import WhisperConfig, WhisperForTranscription
from ser_tpu_torch.ops import decode_step_kernels as dsk

#: Full-width widths that meet every rule (large-v3's heads of 64), two layers.
CARD_SHAPED = WhisperConfig(d_model=128, n_heads=2, encoder_layers=1, decoder_layers=1, vocab_size=64)


def _build(config: WhisperConfig, dtype: str, device: str = "cuda") -> WhisperForTranscription:
    return WhisperForTranscription(config, {}, {}, tokenizer=None, device=device, compute_dtype=dtype)


def test_float32_on_the_card_raises_before_any_weight_is_built() -> None:
    with pytest.raises(NotImplementedError, match="K3, K4 and K5 take bf16 only"):
        _build(CARD_SHAPED, "float32")


@pytest.mark.parametrize(
    ("changes", "rule"),
    [
        ({"d_model": 64, "n_heads": 4}, "head dimension Dh"),
        ({"d_model": 96, "n_heads": 3}, "d % 64 == 0"),
        ({"max_target_positions": 450}, "max_target_positions % 4 == 0"),
    ],
)
def test_shape_rules_of_the_fused_decode_raise_at_construction(changes, rule) -> None:
    with pytest.raises(ValueError, match=rule):
        _build(dataclasses.replace(CARD_SHAPED, **changes), "bfloat16")


@pytest.mark.parametrize(
    ("arguments", "rule"),
    [
        ((1280, 20, 1500, 448), None),
        ((1280, 10, 1500, 448), "head dimension Dh"),
        ((1344, 21, 1500, 448), None),
        ((1312, 20, 1500, 448), "d % 64 == 0"),
        ((1280, 20, 1498, 448), "S % 4 == 0"),
        ((1280, 20, 1500, 446), "max_target_positions % 4 == 0"),
    ],
)
def test_each_rule_is_named(arguments, rule) -> None:
    if rule is None:
        dsk.require_fused_decode_shapes(*arguments)
        return
    with pytest.raises(ValueError, match=rule):
        dsk.require_fused_decode_shapes(*arguments)


def test_the_rules_follow_the_kernels_constants() -> None:
    """Dh = 64, d % 64, and keys in groups of 4: the wrappers' own constants."""
    assert (dsk._HEAD_DIM, dsk._D_ALIGN, dsk._KEY_ALIGN) == (64, 64, 4)
    with pytest.raises(ValueError, match="d % 64 == 0"):
        dsk.require_fused_decode_shapes(96, 1, 1500, 448)
    assert whisper.CHUNK_FRAMES // 2 == 1500


def test_the_cpu_takes_any_shape_and_dtype() -> None:
    """The CPU runs the plain versions: no rule applies, so the build goes on (and fails on the empty state)."""
    with pytest.raises(RuntimeError, match="Missing key"):
        _build(WhisperConfig.tiny(), "float32", device="cpu")
