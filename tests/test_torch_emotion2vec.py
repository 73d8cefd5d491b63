"""The port's emotion2vec converter and backend against ``ser_tpu``'s, on the CPU.

The FunASR-layout checkpoint is the JAX suite's own structurally faithful
stand-in (``build_synthetic_checkpoint`` of
``tests/suites/unit/models/test_emotion2vec_convert.py``: tiny widths, a
7-key AltBlock layout, prenet and trunk, a stacked positional encoder,
decoder/EMA/head keys to skip):

- the inferred configs are equal, and the converted state dict equals
  ``convert.wav2vec2_state_dict`` of ``ser_tpu``'s converted params, with and
  without layer scales, in a fairseq envelope and stored in bf16;
- the converted encoder against ``ser_tpu``'s ``Wav2Vec2Encoder``, masked and
  unmasked, at ``tests/test_torch_wav2vec2.py``'s atol 1e-4, and the backend's
  chunked encode of a clip against ``ser_tpu``'s;
- both packages refuse the same layouts (an unconsumed key, no positional
  encoder) and accept the positional encoder's LayerNorm keys;
- ``resolve_hub`` and the staging roots' order.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.repr.emotion2vec_backend import Emotion2VecBackend as JaxEmotion2VecBackend
from ser_tpu._internal.repr.emotion2vec_backend import resolve_hub as jax_resolve_hub
from ser_tpu.models import emotion2vec_convert as jax_e2v
from ser_tpu.models import wav2vec2 as jax_w2v
from ser_tpu_torch._internal.repr import emotion2vec_backend
from ser_tpu_torch._internal.repr.emotion2vec_backend import Emotion2VecBackend, resolve_hub
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import emotion2vec_convert as e2v
from ser_tpu_torch.models import wav2vec2 as w2v

ATOL = 1e-4
MODEL_ID = "iic/emotion2vec_plus_large"
_SUITE = Path(__file__).resolve().parent / "suites/unit/models/test_emotion2vec_convert.py"


def _suite_module():
    spec = importlib.util.spec_from_file_location("emotion2vec_convert_suite", _SUITE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


build_synthetic_checkpoint = _suite_module().build_synthetic_checkpoint


def _rewrite(model_dir: Path, edit) -> Path:
    """Loads the staged ``model.pt``, applies ``edit`` to its tensor dict, saves it back."""
    state = torch.load(model_dir / "model.pt", weights_only=True)
    torch.save(edit(dict(state)), model_dir / "model.pt")
    return model_dir


def _scaled(state: dict) -> dict:
    """Every weight of two or more dimensions divided by √fan_in."""
    return {key: value / value[0].numel() ** 0.5 if value.ndim >= 2 else value for key, value in state.items()}


def _to_bf16(state: dict) -> dict:
    return {key: value.to(torch.bfloat16) for key, value in state.items()}


VARIANTS = {
    "plain": lambda tmp: build_synthetic_checkpoint(tmp),
    "layer_scale": lambda tmp: build_synthetic_checkpoint(tmp, gamma=True),
    "envelope": lambda tmp: build_synthetic_checkpoint(tmp, envelope=True),
    "bf16": lambda tmp: _rewrite(build_synthetic_checkpoint(tmp, gamma=True), _to_bf16),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_conversion_matches_ser_tpu(tmp_path, variant) -> None:
    model_dir = VARIANTS[variant](tmp_path)
    jax_cfg, params = jax_e2v.load_funasr_emotion2vec_params(model_dir)
    config, state = e2v.load_funasr_emotion2vec_state(model_dir)
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_cfg)
    assert config.conv_pos_depth == 2 and config.num_hidden_layers == 5 and config.num_attention_heads == 1
    reference = convert.wav2vec2_state_dict(params)
    assert sorted(state) == sorted(reference)
    for name, tensor in reference.items():
        assert state[name].dtype == torch.float32, name
        assert torch.equal(state[name], tensor), name
    # The converted state is exactly what the encoder module holds.
    w2v.build_wav2vec2_encoder(config, state, device="cpu")


def test_skipped_keys_and_bf16_upcast_match_ser_tpu(tmp_path) -> None:
    model_dir = VARIANTS["bf16"](tmp_path)
    ours = e2v.load_funasr_state_dict(model_dir)
    theirs = jax_e2v.load_funasr_state_dict(model_dir)
    assert sorted(ours) == sorted(theirs)
    assert not any(key.startswith(("decoder.", "_ema", "proj.")) for key in ours)
    for key, array in theirs.items():
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), array)


def test_in_memory_conversion_equals_the_file_route(tmp_path) -> None:
    model_dir = build_synthetic_checkpoint(tmp_path, gamma=True, envelope=True)
    raw = torch.load(model_dir / "model.pt", weights_only=True)
    config, state = e2v.convert_funasr_state(e2v.normalize_funasr_state(raw))
    file_config, file_state = e2v.load_funasr_emotion2vec_state(model_dir)
    assert config == file_config
    assert all(torch.equal(state[name], file_state[name]) for name in file_state)


def _encode_pair(model_dir: Path, mask: np.ndarray | None, samples: int = 1600):
    jax_cfg, params = jax_e2v.load_funasr_emotion2vec_params(model_dir)
    config, state = e2v.load_funasr_emotion2vec_state(model_dir)
    wave = (0.1 * np.random.default_rng(1).standard_normal((2, samples))).astype(np.float32)
    model = jax_w2v.Wav2Vec2Encoder(jax_cfg)
    apply = jax.jit(lambda p, w, m: model.apply({"params": p}, w, frame_mask=m))
    reference = np.asarray(apply(params, jnp.asarray(wave), None if mask is None else jnp.asarray(mask)))
    encoder = w2v.build_wav2vec2_encoder(config, state, device="cpu")
    with torch.no_grad():
        ours = encoder(torch.from_numpy(wave), None if mask is None else torch.from_numpy(mask)).numpy()
    return ours, reference


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_converted_encoder_matches_ser_tpu(tmp_path, masked) -> None:
    model_dir = build_synthetic_checkpoint(tmp_path, gamma=True)
    config, _ = e2v.load_funasr_emotion2vec_state(model_dir)
    frames = config.frames_for_samples(1600)
    valid = np.array([frames, frames - 37])
    mask = np.arange(frames)[None, :] < valid[:, None] if masked else None
    ours, reference = _encode_pair(model_dir, mask)
    assert ours.shape == reference.shape == (2, frames, 64)
    assert np.isfinite(ours).all()
    rows = np.ones((2, frames), dtype=bool) if mask is None else mask
    # Valid rows only: a padded query attends the valid keys in both packages'
    # CPU routes, but the frames past a row's length carry no contract.
    np.testing.assert_allclose(ours[rows], reference[rows], atol=ATOL, rtol=0)


def test_backend_encode_matches_ser_tpu(tmp_path) -> None:
    """The chunked encode of a 2.5 s clip (masked in its 4 s bucket) with FunASR weights.

    The weights are scaled to 1/√fan_in, as a trained checkpoint's are: the
    suite's unit-variance draws make every product's sum grow with its width,
    and over the 6399 frames of a 4 s bucket (the synthetic front end strides
    10 samples a frame) float32 sums in another order then drift past 1e-4.
    """
    ms_root = tmp_path / "modelscope"
    _rewrite(build_synthetic_checkpoint(ms_root / "iic"), _scaled)
    ours = Emotion2VecBackend(model_id=MODEL_ID, cache_root=tmp_path / "hf", device="cpu",
                              modelscope_cache_root=ms_root)
    theirs = JaxEmotion2VecBackend(model_id=MODEL_ID, cache_root=tmp_path / "hf", modelscope_cache_root=ms_root)
    audio = (0.1 * np.random.default_rng(4).standard_normal(int(2.5 * 16000))).astype(np.float32)
    mine, ref = ours.encode_sequence(audio, 16000), theirs.encode_sequence(audio, 16000)
    assert mine.backend_id == ref.backend_id == ours.backend_id == "emotion2vec"
    np.testing.assert_array_equal(mine.frame_start_seconds, ref.frame_start_seconds)
    np.testing.assert_array_equal(mine.frame_end_seconds, ref.frame_end_seconds)
    np.testing.assert_allclose(np.asarray(mine.embeddings), np.asarray(ref.embeddings), atol=ATOL, rtol=0)


def _add_key(name: str):
    return lambda state: {**state, name: torch.zeros(3)}


def _drop_positional(state: dict) -> dict:
    return {key: value for key, value in state.items() if "relative_positional_encoder" not in key}


REFUSALS = {
    "unconsumed_key": (_add_key("blocks.0.attn.extra.weight"), "unconsumed"),
    "no_positional_encoder": (_drop_positional, "relative_positional_encoder"),
}


@pytest.mark.parametrize("layout", sorted(REFUSALS))
def test_both_packages_refuse_the_same_layouts(tmp_path, layout) -> None:
    edit, message = REFUSALS[layout]
    model_dir = _rewrite(build_synthetic_checkpoint(tmp_path), edit)
    with pytest.raises(KeyError, match=message):
        e2v.load_funasr_emotion2vec_state(model_dir)
    with pytest.raises(KeyError, match=message):
        jax_e2v.load_funasr_emotion2vec_params(model_dir)


def test_positional_layer_norm_keys_are_left_over_in_both(tmp_path) -> None:
    """The positional blocks' LayerNorms run without weights; stray LN keys there are tolerated."""
    key = "modality_encoders.AUDIO.relative_positional_encoder.1.3.weight"
    model_dir = _rewrite(build_synthetic_checkpoint(tmp_path), _add_key(key))
    config, _ = e2v.load_funasr_emotion2vec_state(model_dir)
    jax_cfg, _ = jax_e2v.load_funasr_emotion2vec_params(model_dir)
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_cfg)


HUBS = [
    ("iic/emotion2vec_plus_large", None),
    ("IIC/emotion2vec_base", None),
    ("facebook/data2vec-audio", None),
    ("iic/emotion2vec_plus_large", "hf"),
    ("facebook/data2vec-audio", "ModelScope"),
    ("org/model", " huggingface "),
    ("org/model", "ms"),
]


@pytest.mark.parametrize("model_id, hub", HUBS)
def test_resolve_hub_matches_ser_tpu(model_id, hub) -> None:
    assert resolve_hub(model_id=model_id, hub=hub) == jax_resolve_hub(model_id=model_id, hub=hub)


def test_resolve_hub_refuses_an_unknown_hub() -> None:
    with pytest.raises(ValueError, match="hub must be one of"):
        resolve_hub(model_id="org/model", hub="s3")
    with pytest.raises(ValueError, match="hub must be one of"):
        jax_resolve_hub(model_id="org/model", hub="s3")


@pytest.mark.parametrize("hub, expected", [(None, "ms"), ("hf", "hf")])
def test_staging_roots_are_searched_in_hub_order(tmp_path, hub, expected) -> None:
    """Two checkpoints under one id, one per root: the hub's root wins, in both packages."""
    roots = {"ms": tmp_path / "modelscope", "hf": tmp_path / "huggingface"}
    build_synthetic_checkpoint(roots["ms"] / "iic", gamma=True)
    build_synthetic_checkpoint(roots["hf"] / "iic", gamma=False)
    kwargs = {"model_id": MODEL_ID, "cache_root": roots["hf"], "modelscope_cache_root": roots["ms"], "hub": hub}
    ours = Emotion2VecBackend(device="cpu", **kwargs)
    theirs = JaxEmotion2VecBackend(**kwargs)
    assert ours.hub == theirs.hub == expected
    assert ours.staging_roots(roots["hf"])[0] == roots[expected]
    expected_state = e2v.load_funasr_emotion2vec_state(roots[expected] / MODEL_ID)[1]
    loaded = ours._model.state_dict()
    assert all(torch.equal(loaded[name], expected_state[name]) for name in expected_state)
    reference = convert.wav2vec2_state_dict(theirs._params)
    assert all(torch.equal(loaded[name], reference[name]) for name in reference)


def test_no_weights_raises_as_ser_tpu(tmp_path, monkeypatch) -> None:
    monkeypatch.delenv("SER_ALLOW_RANDOM_INIT", raising=False)
    kwargs = {"model_id": MODEL_ID, "cache_root": tmp_path / "hf", "modelscope_cache_root": tmp_path / "ms"}
    with pytest.raises(RuntimeDependencyError, match="restricted backend"):
        Emotion2VecBackend(device="cpu", **kwargs)
    with pytest.raises(Exception, match="restricted backend"):
        JaxEmotion2VecBackend(**kwargs)


def test_full_size_random_init_is_the_xlsr_layout(tmp_path, monkeypatch) -> None:
    """``SER_RANDOM_INIT_SIZE=full`` builds ``Wav2Vec2Config()``, as the JAX package does."""
    seen = []

    def record(config, **_):
        seen.append(config)
        raise RuntimeError("stop before drawing 300M weights")

    monkeypatch.setenv("SER_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("SER_RANDOM_INIT_SIZE", "full")
    monkeypatch.setattr(emotion2vec_backend.wav2vec2, "random_wav2vec2_state", record)
    with pytest.raises(RuntimeError, match="stop before"):
        Emotion2VecBackend(model_id=MODEL_ID, cache_root=tmp_path, device="cpu")
    assert seen == [w2v.Wav2Vec2Config()]
    assert dataclasses.asdict(seen[0]) == dataclasses.asdict(jax_w2v.Wav2Vec2Config())
    assert seen[0].conv_pos_depth == 1  # not emotion2vec's stacked positional encoder
