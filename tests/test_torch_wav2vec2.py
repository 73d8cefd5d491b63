"""The port's wav2vec2 / XLS-R encoder against ``ser_tpu.models.wav2vec2`` on the CPU.

Tiny configs in float32, the JAX package's own parameters carried across with
``convert.wav2vec2_state_dict``, the same numpy-seeded waveforms:

- the encoder against ``ser_tpu``'s, with and without a frame mask (valid
  frames only: the port masks keys only, ``ROADMAP.md`` Queue 3 item 9), for
  the XLS-R layout, the group-norm front end and data2vec's stacked
  positional convs, at atol 1e-4 (the repo's pin,
  ``tests/suites/unit/models/test_encoders.py``);
- the ``"matmul"`` front end against ``"conv"`` at atol 2e-5, rtol 1e-5;
- ``load_hf_wav2vec2_state`` against the JAX loader on one locally built tiny
  HF checkpoint (``transformers`` builds it; the port reads it with its own
  safetensors reader), the HF forward itself, the manifest, and the refusal
  of an unconsumed tensor;
- ``cast_state_bf16`` against ``cast_params_bf16``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import checkpoint_audit as jax_audit
from ser_tpu.models import param_utils as jax_param_utils
from ser_tpu.models import wav2vec2 as jax_w2v
from ser_tpu_torch.models import checkpoint_audit, convert, hf_checkpoint, param_utils
from ser_tpu_torch.models import wav2vec2 as w2v

transformers = pytest.importorskip("transformers")

ATOL = 1e-4
CONFIGS = {
    "xlsr": {},
    "group_norm": {"feat_extract_norm": "group", "do_stable_layer_norm": False},
    "stacked_pos_conv": {"conv_pos_depth": 2},
}


def _configs(name: str):
    jax_cfg = dataclasses.replace(jax_w2v.Wav2Vec2Config.tiny(), **CONFIGS[name])
    return jax_cfg, w2v.Wav2Vec2Config(**dataclasses.asdict(jax_cfg))


def _waves(batch: int = 2, samples: int = 12000, seed: int = 3) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal((batch, samples))).astype(np.float32)


def _frame_mask(config: w2v.Wav2Vec2Config, samples: int, lengths: list[int]) -> np.ndarray:
    frames = config.frames_for_samples(samples)
    valid = np.array([config.frames_for_samples(n) for n in lengths])
    return np.arange(frames)[None, :] < valid[:, None]


def _jax_params(jax_cfg, seed: int) -> dict:
    """``init_wav2vec2_params``'s initialisation, compiled once (flax's eager init takes seconds)."""
    model = jax_w2v.Wav2Vec2Encoder(jax_cfg)
    return jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 4000), jnp.float32))["params"]


def _pair(name: str, seed: int = 0):
    jax_cfg, cfg = _configs(name)
    params = _jax_params(jax_cfg, seed)
    encoder = w2v.build_wav2vec2_encoder(cfg, convert.wav2vec2_state_dict(params), device="cpu")
    return jax_cfg, cfg, params, encoder


def _jax_encode(jax_cfg, params, wave, mask=None) -> np.ndarray:
    model = jax_w2v.Wav2Vec2Encoder(jax_cfg)
    apply = jax.jit(lambda p, w, m: model.apply({"params": p}, w, frame_mask=m))
    return np.asarray(apply(params, jnp.asarray(wave), None if mask is None else jnp.asarray(mask)))


def _ours(encoder, wave, mask=None) -> np.ndarray:
    with torch.no_grad():
        out = encoder(torch.from_numpy(wave), None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32
    return out.numpy()


def test_config_matches_ser_tpu() -> None:
    for jax_cfg, cfg in (
        (jax_w2v.Wav2Vec2Config(), w2v.Wav2Vec2Config()),
        (jax_w2v.Wav2Vec2Config.tiny(), w2v.Wav2Vec2Config.tiny()),
    ):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
        assert (cfg.frame_stride_samples, cfg.frame_receptive_samples) == (
            jax_cfg.frame_stride_samples,
            jax_cfg.frame_receptive_samples,
        ) == (320, 400)
    assert w2v.Wav2Vec2Config().frames_for_samples(480000) == 1499
    assert w2v.Wav2Vec2Config().frames_for_samples(399) == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name) -> None:
    jax_cfg, _, params, encoder = _pair(name)
    wave = _waves()
    np.testing.assert_allclose(_ours(encoder, wave), _jax_encode(jax_cfg, params, wave), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_masked_encoder_matches_jax_on_valid_frames(name) -> None:
    jax_cfg, cfg, params, encoder = _pair(name, seed=1)
    wave = _waves(samples=16000, seed=4)
    lengths = [16000, 7000]
    wave[1, lengths[1] :] = 0.0
    mask = _frame_mask(cfg, 16000, lengths)
    ours = _ours(encoder, wave, mask)
    ref = _jax_encode(jax_cfg, params, wave, mask)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[mask], ref[mask], atol=ATOL)


def test_matmul_front_end_matches_conv() -> None:
    _, cfg, params, encoder = _pair("xlsr", seed=2)
    matmul = w2v.build_wav2vec2_encoder(
        dataclasses.replace(cfg, frontend_impl="matmul"), convert.wav2vec2_state_dict(params), device="cpu"
    )
    wave = _waves(seed=5)
    out, out_mm = _ours(encoder, wave), _ours(matmul, wave)
    assert out.shape == out_mm.shape
    np.testing.assert_allclose(out_mm, out, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_round_trips_to_the_flax_tree(name) -> None:
    jax_cfg, cfg, params, encoder = _pair(name)
    assert set(convert.wav2vec2_state_dict(params)) == set(encoder.state_dict())
    back = convert.flax_wav2vec2_params(encoder.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_random_state_is_seeded_and_fills_the_model() -> None:
    cfg = w2v.Wav2Vec2Config.tiny()
    first = w2v.random_wav2vec2_state(cfg, seed=3, device="cpu")
    again = w2v.random_wav2vec2_state(cfg, seed=3, device="cpu")
    encoder = w2v.build_wav2vec2_encoder(cfg, first, device="cpu")
    assert all(torch.equal(first[name], again[name]) for name in first)
    assert not torch.equal(first["layers.0.q.weight"], w2v.random_wav2vec2_state(cfg, seed=4, device="cpu")["layers.0.q.weight"])
    assert np.all(np.isfinite(_ours(encoder, _waves())))


def test_bf16_storage_casts_floats_only() -> None:
    state = {"w": torch.ones(3), "steps": torch.arange(3), "flag": torch.tensor([True])}
    cast = param_utils.cast_state_bf16(state)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["steps"].dtype == torch.int64 and cast["flag"].dtype == torch.bool
    jax_cast = jax_param_utils.cast_params_bf16({"w": jnp.ones(3), "steps": jnp.arange(3)})
    assert jax_cast["w"].dtype == jnp.bfloat16 and jax_cast["steps"].dtype == jnp.int32


# --------------------------------------------------------------------------- #
# HF checkpoint
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def hf_wav2vec2_dir(tmp_path_factory):
    cfg = transformers.Wav2Vec2Config(
        vocab_size=32,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        conv_dim=[32, 32],
        conv_kernel=[10, 3],
        conv_stride=[5, 2],
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        feat_extract_norm="layer",
        conv_bias=True,
        do_stable_layer_norm=True,
        apply_spec_augment=False,
    )
    torch.manual_seed(0)
    out = tmp_path_factory.mktemp("hf_wav2vec2")
    transformers.Wav2Vec2Model(cfg).eval().save_pretrained(out, safe_serialization=True)
    return out


def test_hf_loader_matches_jax_loader(hf_wav2vec2_dir) -> None:
    cfg = w2v.config_from_hf_dir(hf_wav2vec2_dir)
    jax_cfg = jax_w2v.config_from_hf_dir(hf_wav2vec2_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    ours = w2v.load_hf_wav2vec2_state(hf_wav2vec2_dir, cfg)
    ref = convert.wav2vec2_state_dict(jax_w2v.load_hf_wav2vec2_params(hf_wav2vec2_dir, jax_cfg))
    assert set(ours) == set(ref)
    for name in ref:
        torch.testing.assert_close(ours[name], ref[name], rtol=0, atol=0)


def test_hf_loaded_encoder_matches_the_hf_forward(hf_wav2vec2_dir) -> None:
    cfg = w2v.config_from_hf_dir(hf_wav2vec2_dir)
    encoder = w2v.build_wav2vec2_encoder(cfg, w2v.load_hf_wav2vec2_state(hf_wav2vec2_dir, cfg), device="cpu")
    hf_model = transformers.Wav2Vec2Model.from_pretrained(hf_wav2vec2_dir).eval()
    wave = _waves(samples=3200, seed=11)
    with torch.no_grad():
        hf_hidden = hf_model(torch.from_numpy(wave)).last_hidden_state.numpy()
    np.testing.assert_allclose(_ours(encoder, wave), hf_hidden, atol=ATOL)


def test_manifest_matches_jax_and_the_checkpoint(hf_wav2vec2_dir) -> None:
    cfg = w2v.config_from_hf_dir(hf_wav2vec2_dir)
    ours = checkpoint_audit.wav2vec2_manifest(cfg)
    ref = jax_audit.wav2vec2_manifest(jax_w2v.config_from_hf_dir(hf_wav2vec2_dir))
    assert ours.required == ref.required and ours.alternative_groups == ref.alternative_groups
    assert checkpoint_audit.WAV2VEC2_IGNORED == jax_audit.WAV2VEC2_IGNORED
    shapes = {name: array.shape for name, array in hf_checkpoint.read_hf_tensors(hf_wav2vec2_dir).items()}
    assert ours.validate(shapes).ok
    assert not ours.validate({**shapes, "encoder.adapter.weight": (4, 4)}).ok


def _bin_checkpoint(hf_wav2vec2_dir, target, extra: dict[str, np.ndarray]):
    state = {
        name: torch.from_numpy(np.array(array))
        for name, array in {**hf_checkpoint.read_hf_tensors(hf_wav2vec2_dir), **extra}.items()
    }
    target.mkdir()
    torch.save(state, target / "pytorch_model.bin")
    (target / "config.json").write_text((hf_wav2vec2_dir / "config.json").read_text(encoding="utf-8"), encoding="utf-8")
    return target


def test_unconsumed_tensor_refuses_the_load(hf_wav2vec2_dir, tmp_path) -> None:
    model_dir = _bin_checkpoint(hf_wav2vec2_dir, tmp_path / "adapter", {"encoder.adapter.weight": np.zeros((4, 4))})
    cfg = w2v.config_from_hf_dir(model_dir)
    with pytest.raises(KeyError, match="unconsumed"):
        w2v.load_hf_wav2vec2_state(model_dir, cfg)
    with pytest.raises(KeyError, match="unconsumed"):
        jax_w2v.load_hf_wav2vec2_params(model_dir, jax_w2v.config_from_hf_dir(model_dir))


def test_pretraining_heads_are_ignored(hf_wav2vec2_dir, tmp_path) -> None:
    extra = {"quantizer.codevectors": np.zeros((1, 4, 8)), "wav2vec2.masked_spec_embed": np.zeros(64)}
    model_dir = _bin_checkpoint(hf_wav2vec2_dir, tmp_path / "heads", extra)
    cfg = w2v.config_from_hf_dir(model_dir)
    ours = w2v.load_hf_wav2vec2_state(model_dir, cfg)
    assert set(ours) == set(w2v.load_hf_wav2vec2_state(hf_wav2vec2_dir, cfg))
