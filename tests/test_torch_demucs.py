"""htdemucs v4 of the port against ``ser_tpu.models.demucs_v4``, on the CPU.

- the synthetic state dict is bit-equal to the JAX package's for the same
  seed and config (the tiny one and the published one);
- each block (frequency and time encoder layers, decoder layers, the
  cross-domain transformer), the spectrogram round trip, the full forward and
  the vocals forward agree with the JAX package's on the same numpy-seeded
  inputs at the repo's ATOL 2e-4 (``test_demucs_torch_mirror.py``'s), the
  round trip at 1e-5; each JAX function runs jitted, once;
- a synthetic published ``.th`` (half precision, ``{"klass", "kwargs",
  "state"}``) converts to the JAX converter's tree and config;
- ``config_from_checkpoint_kwargs`` refuses what the JAX package refuses and
  warns on unknown kwargs;
- an ``.npz`` written by either package loads in the other;
- ``separate_vocals_demucs`` agrees with the JAX package's over several
  dispatches (``SER_DEMUCS_MAX_DEVICE_ROWS=2``, 13 segments): the port runs
  the last dispatch's one real row where the JAX package pads it to two, and
  the results agree all the same (``ROADMAP.md``, Queue 3).
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Iterator
from contextlib import contextmanager
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import demucs_v4 as jdm
from ser_tpu.models._demucs_synthetic import synthetic_state_dict as jax_synthetic
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import demucs_v4 as tdm
from ser_tpu_torch.models._demucs_synthetic import synthetic_state_dict

JAX_CFG = jdm.DemucsV4Config.tiny()
CFG = tdm.DemucsV4Config.tiny()
#: The repo's bar for the demucs lane against its torch mirror.
ATOL = 2e-4


@pytest.fixture(scope="module")
def state() -> dict:
    return synthetic_state_dict(CFG, seed=3)


@pytest.fixture(scope="module")
def jax_params(state):
    return jax.tree_util.tree_map(jnp.asarray, jdm.convert_demucs_state_dict(state, JAX_CFG))


@pytest.fixture(scope="module")
def params(state):
    return convert.demucs_params(tdm.convert_demucs_state_dict(state, CFG), device="cpu")


def test_configs_match_jax() -> None:
    for name in ("tiny", None):
        ours = CFG if name else tdm.DemucsV4Config()
        ref = JAX_CFG if name else jdm.DemucsV4Config()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("config, seed", [("tiny", 3), ("tiny", 11), ("published", 0)])
def test_synthetic_state_dict_is_bit_equal(config, seed) -> None:
    ours = synthetic_state_dict(CFG if config == "tiny" else tdm.DemucsV4Config(), seed=seed)
    ref = jax_synthetic(JAX_CFG if config == "tiny" else jdm.DemucsV4Config(), seed=seed)
    assert list(ours) == list(ref)
    for name, value in ref.items():
        assert ours[name].dtype == value.dtype and np.array_equal(ours[name], value), name


def _rng_input(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _block_cases():
    chin, d = CFG.layer_channels(CFG.depth - 1), CFG.bottom_channels
    return {
        "freq-encoder": (
            lambda p, x: tdm._henc_layer(x, p["encoder"][0], CFG, freq=True),
            lambda p, x: jdm._henc_layer(x, p["encoder"][0], JAX_CFG, freq=True),
            [_rng_input(0, 2, 4, CFG.freq_bins, 6)],
        ),
        "time-encoder": (
            lambda p, x: tdm._henc_layer(x, p["tencoder"][0], CFG, freq=False),
            lambda p, x: jdm._henc_layer(x, p["tencoder"][0], JAX_CFG, freq=False),
            [_rng_input(1, 2, CFG.audio_channels, 241)],
        ),
        "freq-decoder": (
            lambda p, x, s: tdm._hdec_layer(x, s, p["decoder"][0], CFG, freq=True, last=False, length=0),
            lambda p, x, s: jdm._hdec_layer(x, s, p["decoder"][0], JAX_CFG, freq=True, last=False, length=0),
            [_rng_input(2, 2, chin, 2, 6), _rng_input(3, 2, chin, 2, 6)],
        ),
        "time-decoder": (
            lambda p, x, s: tdm._hdec_layer(x, s, p["tdecoder"][0], CFG, freq=False, last=False, length=37),
            lambda p, x, s: jdm._hdec_layer(x, s, p["tdecoder"][0], JAX_CFG, freq=False, last=False, length=37),
            [_rng_input(4, 2, chin, 10), _rng_input(5, 2, chin, 10)],
        ),
        "last-decoder": (
            lambda p, x, s: tdm._hdec_layer(x, s, p["decoder"][1], CFG, freq=True, last=True, length=0),
            lambda p, x, s: jdm._hdec_layer(x, s, p["decoder"][1], JAX_CFG, freq=True, last=True, length=0),
            [_rng_input(6, 2, CFG.channels, 8, 6), _rng_input(7, 2, CFG.channels, 8, 6)],
        ),
        "crosstransformer": (
            lambda p, x, xt: torch.cat(
                [y.flatten(1) for y in tdm._crosstransformer(x, xt, p["crosstransformer"], CFG)], dim=1
            ),
            lambda p, x, xt: jnp.concatenate(
                [y.reshape(y.shape[0], -1) for y in jdm._crosstransformer(x, xt, p["crosstransformer"], JAX_CFG)],
                axis=1,
            ),
            [_rng_input(8, 2, d, 2, 6), _rng_input(9, 2, d, 10)],
        ),
    }


@pytest.mark.parametrize("block", list(_block_cases()))
def test_block_matches_jax(block, params, jax_params) -> None:
    ours_fn, ref_fn, inputs = _block_cases()[block]
    with torch.no_grad():
        ours = ours_fn(params, *(torch.from_numpy(x) for x in inputs)).numpy()
    ref = np.asarray(jax.jit(partial(ref_fn, jax_params))(*(jnp.asarray(x) for x in inputs)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_spec_round_trip_matches_jax() -> None:
    mix = (0.2 * _rng_input(10, 1, 2, CFG.segment_samples)).astype(np.float32)
    ours = tdm._spec(torch.from_numpy(mix), CFG)
    ref = jax.jit(lambda m: jdm._spec(m, JAX_CFG))(jnp.asarray(mix))
    np.testing.assert_allclose(ours.real.numpy(), np.asarray(ref.real), atol=1e-5)
    np.testing.assert_allclose(ours.imag.numpy(), np.asarray(ref.imag), atol=1e-5)
    back = tdm._ispec(ours, CFG, CFG.segment_samples).numpy()
    ref_back = np.asarray(jax.jit(lambda z: jdm._ispec(z, JAX_CFG, JAX_CFG.segment_samples))(ref))
    np.testing.assert_allclose(back, ref_back, atol=1e-5)


@pytest.fixture(scope="module")
def forward_pair(params, jax_params):
    """The full forward of both packages on one 2-row batch (JAX's jitted, once)."""
    mix = (0.2 * _rng_input(11, 2, CFG.audio_channels, CFG.segment_samples)).astype(np.float32)
    with torch.no_grad():
        ours = tdm.demucs_forward(params, torch.from_numpy(mix), CFG).numpy()
    ref = np.asarray(jdm._compiled_forward(jax_params, jnp.asarray(mix), JAX_CFG))
    return mix, ours, ref


def test_full_forward_matches_jax(forward_pair) -> None:
    _, ours, ref = forward_pair
    assert ours.shape == ref.shape == (2, len(CFG.sources), CFG.audio_channels, CFG.segment_samples)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    assert np.abs(ref).max() > 10 * ATOL


def test_vocals_forward_matches_jax(params, forward_pair) -> None:
    mix, full, ref_full = forward_pair
    vocals = CFG.sources.index("vocals")
    ours = tdm.vocals_forward(params, torch.from_numpy(mix), CFG, vocals).numpy()
    np.testing.assert_allclose(ours, ref_full[:, vocals].mean(axis=1), atol=ATOL)
    np.testing.assert_array_equal(ours, full[:, vocals].mean(axis=1))


def _synthetic_th(path, seed: int):
    state = {key: torch.from_numpy(value).half() for key, value in synthetic_state_dict(CFG, seed=seed).items()}
    kwargs = {
        "sources": list(CFG.sources), "audio_channels": CFG.audio_channels, "channels": CFG.channels,
        "depth": CFG.depth, "nfft": CFG.nfft, "bottom_channels": CFG.bottom_channels,
        "t_layers": CFG.t_layers, "t_heads": CFG.t_heads, "samplerate": CFG.sample_rate,
        "segment": CFG.segment_seconds,
    }
    torch.save({"klass": "HTDemucs", "kwargs": kwargs, "state": state}, path)
    return path


def _assert_same_tree(ours, ref) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(ours)
    ref_leaves, ref_treedef = jax.tree_util.tree_flatten(ref)
    assert treedef == ref_treedef
    for a, b in zip(leaves, ref_leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_th_converts_like_jax(tmp_path) -> None:
    source = _synthetic_th(tmp_path / "955717e8-synthetic.th", seed=7)
    ours, config = tdm.load_torch_checkpoint(source)
    ref, ref_config = jdm.load_torch_checkpoint(source)
    assert config == CFG and dataclasses.asdict(config) == dataclasses.asdict(ref_config)
    _assert_same_tree(ours, ref)
    target = tmp_path / "htdemucs.npz"
    assert tdm.convert_demucs_checkpoint(source, target) == CFG
    loaded, loaded_config = jdm.load_demucs_npz(target)
    assert loaded_config == JAX_CFG
    _assert_same_tree(ours, loaded)


def test_converter_refuses_missing_and_extra_weights() -> None:
    state = synthetic_state_dict(CFG)
    del state["encoder.0.conv.weight"]
    with pytest.raises(KeyError, match="encoder.0.conv.weight"):
        tdm.convert_demucs_state_dict(state, CFG)
    state = synthetic_state_dict(CFG)
    state["encoder.0.dconv.layers.0.2.attn.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        tdm.convert_demucs_state_dict(state, CFG)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        ({"dconv_mode": 3}, "dconv_mode"),
        ({"cac": False}, "cac"),
        ({"t_emb": "scaled"}, "t_emb"),
        ({"depth": 4, "norm_starts": 2}, "norm_starts"),
    ],
)
def test_config_refusals_match_jax(kwargs, match) -> None:
    with pytest.raises(ValueError, match=match):
        tdm.config_from_checkpoint_kwargs(kwargs)
    with pytest.raises(ValueError, match=match):
        jdm.config_from_checkpoint_kwargs(kwargs)


@contextmanager
def _package_records(caplog, package: str, level: int | str = logging.WARNING) -> Iterator[None]:
    """``caplog`` at ``level`` with its handler on ``package``'s root logger itself, for the scope.

    The package's ``configure_logging`` (which an in-process CLI run calls)
    stops that logger propagating, once per process; ``caplog`` listens on the
    root logger and would then miss the records of any later test in the
    process. Propagation is off for the scope, so each record reaches the
    handler once.
    """
    logger = logging.getLogger(package)
    propagate = logger.propagate
    logger.addHandler(caplog.handler)
    logger.propagate = False
    try:
        with caplog.at_level(level, logger=package):
            yield
    finally:
        logger.removeHandler(caplog.handler)
        logger.propagate = propagate


def test_config_from_kwargs_matches_jax(caplog) -> None:
    kwargs = {"sources": ["vocals", "other"], "channels": 32, "depth": 3, "norm_starts": 4, "segment": 6,
              "t_dropout": 0.1, "freq_emb": 0.3, "wiener_iters": 0, "mystery_knob": 1}
    with _package_records(caplog, "ser_tpu_torch"):
        ours = tdm.config_from_checkpoint_kwargs(kwargs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(jdm.config_from_checkpoint_kwargs(kwargs))
    assert [r for r in caplog.records if "mystery_knob" in r.getMessage()]


def test_npz_loads_across_packages(tmp_path) -> None:
    ours = tdm.init_demucs_params(CFG, seed=5)
    ref = jdm.init_demucs_params(JAX_CFG, seed=5)
    _assert_same_tree(ours, ref)
    tdm.save_demucs_npz(ours, tmp_path / "port.npz", config=CFG)
    jdm.save_demucs_npz(ref, tmp_path / "jax.npz", config=JAX_CFG)
    assert tdm.is_demucs_npz(tmp_path / "jax.npz") and jdm.is_demucs_npz(tmp_path / "port.npz")
    loaded_by_jax, jax_config = jdm.load_demucs_npz(tmp_path / "port.npz")
    loaded_by_port, port_config = tdm.load_demucs_npz(tmp_path / "jax.npz")
    assert jax_config == JAX_CFG and port_config == CFG
    _assert_same_tree(loaded_by_port, ref)
    _assert_same_tree(ours, loaded_by_jax)
    # Tensors on a device save like numpy leaves.
    tdm.save_demucs_npz(convert.demucs_params(ours, device="cpu"), tmp_path / "tensors.npz", config=CFG)
    _assert_same_tree(tdm.load_demucs_npz(tmp_path / "tensors.npz")[0], ref)


def test_separate_vocals_demucs_matches_jax_over_dispatches(params, jax_params, monkeypatch) -> None:
    monkeypatch.setenv("SER_DEMUCS_MAX_DEVICE_ROWS", "2")
    audio = (0.1 * _rng_input(12, 3000)).astype(np.float32)  # 8269 samples at 44.1 kHz: 13 segments
    rows: list[int] = []
    forward = tdm.vocals_forward

    def counting(p, mix, config, index):
        rows.append(mix.shape[0])
        return forward(p, mix, config, index)

    monkeypatch.setattr(tdm, "vocals_forward", counting)
    ours = tdm.separate_vocals_demucs(audio, 16000, params=params, config=CFG)
    ref = jdm.separate_vocals_demucs(audio, 16000, params=jax_params, config=JAX_CFG)
    assert rows == [2] * 6 + [1]
    assert ours.shape == ref.shape == audio.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    assert np.abs(ref).max() > 10 * ATOL


def test_host_params_go_to_the_settings_device(monkeypatch) -> None:
    """Numpy leaves go to ``SER_TORCH_DEVICE``'s device: with no card, ``auto`` raises."""
    tree = tdm.init_demucs_params(CFG, seed=1)
    audio = (0.1 * _rng_input(13, 1600)).astype(np.float32)
    monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        tdm.separate_vocals_demucs(audio, 16000, params=tree, config=CFG)
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    out = tdm.separate_vocals_demucs(audio, 16000, params=tree, config=CFG)
    assert out.shape == audio.shape and np.isfinite(out).all()
    placed = convert.demucs_params(tree, device="cpu")
    np.testing.assert_array_equal(out, tdm.separate_vocals_demucs(audio, 16000, params=placed, config=CFG))
