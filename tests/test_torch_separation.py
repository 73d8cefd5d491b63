"""The spectrogram U-Net separator and the separation routing of the port against ``ser_tpu``, on the CPU.

- each U-Net block (the GLU conv, the bottleneck layer, the SAME transposed
  conv with its unflipped kernel) and the whole mask agree with flax's, given
  flax's parameters carried across by ``models/convert.py``, at
  ``UNET_ATOL`` = 1e-5 (float32; flax takes norm statistics as E[x²] - E[x]²,
  PyTorch in two passes, and the two FFTs round differently), at the tiny
  config and at one whose frequency stride equals its kernel (lax's other
  SAME branch);
- the tree ↔ state dict converter round-trips bit for bit, and the port's
  seeded init has flax's tree, shapes and initializer scales;
- ``separate_vocals_neural`` agrees with the JAX package's (which pads the
  rows to a power of two; the port does not);
- ``separation_loss`` and its gradient agree with ``jax.value_and_grad`` at
  rtol 1e-5 (each gradient entry within 1e-5 of itself or of the gradient's
  largest entry);
- an ``.npz`` written by either package loads in the other;
- ``separate_vocals_auto`` routes a converted htdemucs ``.npz`` to htdemucs
  and any other ``.npz`` to the U-Net, on the device it is given; a missing
  path takes REPET-SIM with one warning; a U-Net checkpoint of another rate
  raises; with no card a staged checkpoint raises unless
  ``SER_TORCH_DEVICE=cpu``;
- the transcriber separates (and gates) the audio before the decode, as the
  JAX transcriber does.
"""

from __future__ import annotations

import dataclasses
import logging
import wave
from collections.abc import Iterator
from contextlib import contextmanager

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.transcript.jax_whisper_backend import JaxWhisperTranscriber
from ser_tpu._internal.utils import source_separation as jax_routing
from ser_tpu.models import separation as jsep
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.transcript.whisper_backend import WhisperTranscriber
from ser_tpu_torch._internal.utils import source_separation as routing
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch._internal.utils.denoise import spectral_gate_denoise
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import demucs_v4 as tdm
from ser_tpu_torch.models import separation as tsep

#: U-Net against flax, float32 (see the module docstring).
UNET_ATOL = 1e-5
#: The loss and its gradient against ``jax.value_and_grad``.
LOSS_RTOL = 1e-5

CONFIGS = {
    "tiny": jsep.SeparatorConfig.tiny(),
    "stride-eq-kernel": dataclasses.replace(
        jsep.SeparatorConfig.tiny(), freq_kernel=4, freq_stride=4, time_kernel=5, channels=(8, 12)
    ),
}


def _port_config(config: jsep.SeparatorConfig) -> tsep.SeparatorConfig:
    return tsep.SeparatorConfig(**dataclasses.asdict(config))


def _numpy_tree(tree) -> dict:
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def flax_params() -> dict:
    return {
        name: jax.jit(lambda config=config: jsep.init_separator_params(config, seed=0))()
        for name, config in CONFIGS.items()
    }


@pytest.fixture(scope="module")
def models(flax_params) -> dict:
    return {
        name: tsep.build_separator(_numpy_tree(flax_params[name]), _port_config(config), device="cpu")
        for name, config in CONFIGS.items()
    }


def _rand(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_configs_match_jax() -> None:
    assert dataclasses.asdict(tsep.SeparatorConfig()) == dataclasses.asdict(jsep.SeparatorConfig())
    assert dataclasses.asdict(tsep.SeparatorConfig.tiny()) == dataclasses.asdict(jsep.SeparatorConfig.tiny())


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("block", ["glu-conv", "bottleneck", "transpose", "transpose-last", "mask"])
def test_unet_block_matches_flax(name, block, flax_params, models) -> None:
    config, params, model = CONFIGS[name], flax_params[name], models[name]
    frames = 1 + config.segment_samples // config.hop
    if block == "glu-conv":
        x = _rand(1, 2, frames, config.freq_bins // config.freq_stride, config.channels[0])
        ref = jax.jit(jsep._GLUConv(config.channels[1], config.time_kernel, config.freq_kernel, config.freq_stride).apply)(
            {"params": params["enc1"]}, jnp.asarray(x)
        )
        ours = model.enc[1](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    elif block == "bottleneck":
        x = _rand(2, 2, frames, config.channels[-1])
        ref = jax.jit(jsep._BottleneckLayer(heads=config.bottleneck_heads).apply)(
            {"params": params["bottleneck0"]}, jnp.asarray(x)
        )
        ours = model.bottleneck[0](torch.from_numpy(x))
    elif block.startswith("transpose"):
        index = 1 if block == "transpose" else 0
        x = _rand(3, 2, frames, 5, config.channels[index])
        layer = flax_nn.ConvTranspose(
            features=1 if index == 0 else config.channels[index - 1],
            kernel_size=(config.time_kernel, config.freq_kernel),
            strides=(1, config.freq_stride),
            padding="SAME",
        )
        ref = jax.jit(layer.apply)({"params": params[f"dec{index}"]}, jnp.asarray(x))
        ours = tsep._same_transpose(model.dec[index], torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        x = np.abs(_rand(4, 2, frames, config.freq_bins))
        ref = jax.jit(jsep.SpecUNetSeparator(config).apply)({"params": params}, jnp.asarray(x))
        ours = model(torch.from_numpy(x))
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, np.asarray(ref), atol=UNET_ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tree_and_init_match_flax(name, flax_params, models) -> None:
    config, ref = CONFIGS[name], _numpy_tree(flax_params[name])
    back = convert.flax_separator_params(models[name].state_dict(), _port_config(config))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for ours, theirs in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
    drawn = tsep.init_separator_params(_port_config(config), seed=0)
    assert jax.tree_util.tree_map(np.shape, drawn) == jax.tree_util.tree_map(np.shape, ref)
    assert jax.tree_util.tree_structure(drawn) == jax.tree_util.tree_structure(ref)
    # Kernels: LeCun-normal scale, truncated at two deviations; biases zero; norm scales one.
    kernel = drawn["bottleneck0"]["ffn_up"]["kernel"]
    fan_in = kernel.shape[0]
    assert abs(kernel.std() * np.sqrt(fan_in) - 1.0) < 0.1
    assert np.abs(kernel).max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert not drawn["enc0"]["conv"]["bias"].any() and (drawn["enc0"]["norm"]["scale"] == 1).all()
    np.testing.assert_array_equal(tsep.init_separator_params(_port_config(config), seed=0)["dec0"]["kernel"],
                                  drawn["dec0"]["kernel"])


def test_separate_vocals_neural_matches_jax(flax_params, models) -> None:
    config = CONFIGS["tiny"]
    audio = _rand(5, int(2.2 * config.sample_rate))  # 1 s segments: three rows, which JAX pads to four
    ours = tsep.separate_vocals_neural(audio, config.sample_rate, model=models["tiny"])
    ref = jsep.separate_vocals_neural(audio, config.sample_rate, params=flax_params["tiny"], config=config)
    assert ours.shape == ref.shape == audio.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=UNET_ATOL)
    with pytest.raises(ValueError, match="Hz"):
        tsep.separate_vocals_neural(audio, 8000, model=models["tiny"])


def test_loss_and_gradient_match_jax(flax_params, models) -> None:
    config, params, model = CONFIGS["tiny"], flax_params["tiny"], models["tiny"]
    mixture = _rand(6, 2, config.segment_samples)
    target = 0.5 * mixture + 0.1 * _rand(7, 2, config.segment_samples)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jsep.separation_loss(p, jnp.asarray(mixture), jnp.asarray(target), config)
    ))(params)
    model.zero_grad()
    loss = tsep.separation_loss(model, torch.from_numpy(mixture), torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    grads = convert.flax_separator_params({k: p.grad for k, p in model.named_parameters()}, _port_config(config))
    ref_leaves = jax.tree_util.tree_leaves(_numpy_tree(ref_grads))
    # The encoder's conv biases feed a GroupNorm, so their gradients are zero up to rounding (1e-11):
    # entries are held within rtol of themselves or of the gradient's largest entry.
    largest = max(np.abs(leaf).max() for leaf in ref_leaves)
    for ours, ref in zip(jax.tree_util.tree_leaves(grads), ref_leaves):
        np.testing.assert_allclose(ours, ref, rtol=LOSS_RTOL, atol=LOSS_RTOL * largest)
    model.zero_grad()


def test_npz_loads_across_packages(tmp_path, flax_params) -> None:
    config = CONFIGS["tiny"]
    port_config = _port_config(config)
    drawn = tsep.init_separator_params(port_config, seed=4)
    tsep.save_separator_params(drawn, tmp_path / "port.npz", config=port_config)
    jsep.save_separator_params(flax_params["tiny"], tmp_path / "jax.npz", config=config)
    loaded_by_jax, jax_config = jsep.load_separator_params(tmp_path / "port.npz")
    loaded_by_port, port_loaded_config = tsep.load_separator_params(tmp_path / "jax.npz")
    assert jax_config == config and port_loaded_config == port_config
    for ours, ref in ((drawn, loaded_by_jax), (loaded_by_port, flax_params["tiny"])):
        assert jax.tree_util.tree_structure(_numpy_tree(ours)) == jax.tree_util.tree_structure(_numpy_tree(ref))
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # The port's seeded weights run in the JAX package as in the port.
    magnitude = np.abs(_rand(8, 1, 1 + config.segment_samples // config.hop, config.freq_bins))
    ref = jax.jit(jsep.SpecUNetSeparator(config).apply)({"params": loaded_by_jax}, jnp.asarray(magnitude))
    with torch.no_grad():
        ours = tsep.build_separator(drawn, port_config, device="cpu")(torch.from_numpy(magnitude))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=UNET_ATOL)
    assert tsep.load_separator_params(tmp_path / "port.npz")[1] == port_config


# --------------------------------------------------------------------------- #
# separate_vocals_auto and the transcriber
# --------------------------------------------------------------------------- #


@pytest.fixture()
def staged(tmp_path, flax_params, monkeypatch) -> dict:
    """A U-Net and an htdemucs checkpoint on disk; no separation variables set; caches empty."""
    monkeypatch.delenv("SER_SEPARATION_MODEL_PATH", raising=False)
    monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(routing, "_NEURAL_PARAM_CACHE", {})
    monkeypatch.setattr(routing, "_MISSING_WARNED", set())
    unet = tmp_path / "unet.npz"
    jsep.save_separator_params(flax_params["tiny"], unet, config=CONFIGS["tiny"])
    demucs = tmp_path / "htdemucs.npz"
    tdm.save_demucs_npz(tdm.init_demucs_params(tdm.DemucsV4Config.tiny(), seed=9), demucs,
                        config=tdm.DemucsV4Config.tiny())
    return {"unet": unet, "demucs": demucs}


def test_routing_to_each_separator(staged, models, monkeypatch) -> None:
    audio = (0.2 * _rand(9, 8000)).astype(np.float32)
    monkeypatch.setenv("SER_SEPARATION_MODEL_PATH", str(staged["unet"]))
    unet = routing.separate_vocals_auto(audio, 16000, device="cpu")
    np.testing.assert_array_equal(unet, tsep.separate_vocals_neural(audio, 16000, model=models["tiny"]))
    demucs = routing.separate_vocals_auto(audio, 16000, model_path=staged["demucs"], device="cpu")
    params, config = tdm.load_demucs_npz(staged["demucs"])
    params = convert.demucs_params(params, device="cpu")
    np.testing.assert_array_equal(demucs, tdm.separate_vocals_demucs(audio, 16000, params=params, config=config))
    assert sorted(kind for kind, _ in routing._NEURAL_PARAM_CACHE.values()) == ["demucs_v4", "spec_unet"]
    assert {device for _, device in routing._NEURAL_PARAM_CACHE} == {"cpu"}
    # The weights stay on the device they were loaded to, once per path.
    routing.separate_vocals_auto(audio, 16000, device="cpu")
    assert len(routing._NEURAL_PARAM_CACHE) == 2
    # The JAX package routes the same checkpoints to the same separators.
    jax_routing._NEURAL_PARAM_CACHE.clear()
    np.testing.assert_allclose(unet, jax_routing.separate_vocals_auto(audio, 16000), atol=UNET_ATOL)
    jax_routing._NEURAL_PARAM_CACHE.clear()


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


def test_missing_checkpoint_takes_repet_sim_with_one_warning(staged, tmp_path, caplog) -> None:
    audio = (0.2 * _rand(10, 16000)).astype(np.float32)
    missing = tmp_path / "absent.npz"
    with _package_records(caplog, "ser_tpu_torch"):
        first = routing.separate_vocals_auto(audio, 16000, model_path=missing)
        second = routing.separate_vocals_auto(audio, 16000, model_path=missing)
    np.testing.assert_array_equal(first, routing.separate_vocals(audio, 16000))
    np.testing.assert_array_equal(second, first)
    assert len([r for r in caplog.records if "does not exist" in r.getMessage()]) == 1
    assert routing._NEURAL_PARAM_CACHE == {}


def test_unet_of_another_rate_is_refused(staged, tmp_path, flax_params) -> None:
    path = tmp_path / "sep8k.npz"
    jsep.save_separator_params(flax_params["tiny"], path, config=dataclasses.replace(CONFIGS["tiny"], sample_rate=8000))
    with pytest.raises(ValueError, match="8000 Hz"):
        routing.separate_vocals_auto(np.zeros(16000, np.float32), 16000, model_path=path, device="cpu")


@pytest.mark.parametrize("kind", ["unet", "demucs"])
def test_staged_checkpoint_needs_the_card_or_a_cpu_request(staged, kind, monkeypatch) -> None:
    from ser_tpu_torch._internal.config.bootstrap import build_settings

    audio = (0.2 * _rand(11, 4000)).astype(np.float32)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        routing.separate_vocals_auto(audio, 16000, model_path=staged[kind])
    settings = build_settings({"SER_SEPARATION_MODEL_PATH": str(staged[kind])})
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        routing.separate_vocals_auto(audio, 16000, settings=settings)
    assert routing._NEURAL_PARAM_CACHE == {}
    cpu_settings = build_settings({"SER_SEPARATION_MODEL_PATH": str(staged[kind]), "SER_TORCH_DEVICE": "cpu"})
    by_settings = routing.separate_vocals_auto(audio, 16000, settings=cpu_settings)
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    np.testing.assert_array_equal(by_settings, routing.separate_vocals_auto(audio, 16000, model_path=staged[kind]))
    assert not np.allclose(by_settings, routing.separate_vocals(audio, 16000))


def _write_wav(path, audio: np.ndarray) -> np.ndarray:
    """Writes 16-bit PCM; returns the samples as the port's reader gives them."""
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(16000)
        handle.writeframes((audio * 32767).astype(np.int16).tobytes())
    samples, rate = read_audio_file(str(path))
    assert rate == 16000
    return samples


@pytest.mark.parametrize("kind", ["unet", "demucs"])
def test_transcriber_separates_before_decode(staged, kind, tmp_path, monkeypatch) -> None:
    """``use_demucs`` transforms the audio on the transcriber's device before it reaches the decoder."""
    audio = (0.2 * _rand(12, 16000)).astype(np.float32)
    decoded = _write_wav(tmp_path / "clip.wav", audio)
    monkeypatch.setenv("SER_SEPARATION_MODEL_PATH", str(staged[kind]))
    captured: dict[str, np.ndarray] = {}

    class _ModelDouble:
        def __init__(self, name: str) -> None:
            self.name = name

        def transcribe_words(self, received, *, language, use_vad):
            captured[self.name] = np.asarray(received)
            return []

    ours = WhisperTranscriber(model_name="tiny", cache_root=tmp_path, device="cpu", use_demucs=True, use_vad=False)
    ours._model = _ModelDouble("port")
    assert ours.transcribe(str(tmp_path / "clip.wav"), language="en") == []
    reference = JaxWhisperTranscriber(model_name="tiny", cache_root=tmp_path, use_demucs=True, use_vad=False)
    reference._model = _ModelDouble("jax")
    jax_routing._NEURAL_PARAM_CACHE.clear()
    reference.transcribe(str(tmp_path / "clip.wav"), language="en")
    jax_routing._NEURAL_PARAM_CACHE.clear()
    assert captured["port"].shape == audio.shape
    assert not np.allclose(captured["port"], decoded, atol=1e-4)
    separated = routing.separate_vocals_auto(decoded, 16000, device="cpu")
    np.testing.assert_array_equal(captured["port"], spectral_gate_denoise(separated))
    np.testing.assert_allclose(captured["port"], captured["jax"], atol=2e-4 if kind == "demucs" else UNET_ATOL)
    assert not any("not ported" in issue.message for issue in ours.check_compatibility().issues)
