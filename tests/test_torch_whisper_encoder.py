"""Whisper encoder of the PyTorch port against the JAX encoder, on the CPU.

JAX's own parameters (``init_whisper_encoder_params``) are carried across with
``convert.py``; the encoder states of two 30 s windows agree at 1e-4 (the
tolerance the JAX package pins against HF's torch Whisper). The HF loader
returns the same parameter tree as the JAX loader and keeps its refusal of
unconsumed encoder tensors, and the port's encoder on a random-init HF
checkpoint's weights agrees with ``transformers.WhisperModel(cfg).encoder``
at 1e-4.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import whisper as jax_whisper
from ser_tpu_torch.models import convert, hf_checkpoint
from ser_tpu_torch.models import whisper as torch_whisper

ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params() -> dict:
    params = jax_whisper.init_whisper_encoder_params(jax_whisper.WhisperConfig.tiny(), seed=0)
    return jax.tree_util.tree_map(np.asarray, params)


def _encoder(params: dict, dtype: torch.dtype = torch.float32) -> torch_whisper.WhisperEncoder:
    return torch_whisper.build_whisper_encoder(
        torch_whisper.WhisperConfig.tiny(),
        convert.whisper_encoder_state_dict(params),
        device=torch.device("cpu"),
        dtype=dtype,
    )


def test_encode_mel_chunks_matches_jax_encoder(jax_params) -> None:
    rng = np.random.default_rng(1)
    chunks = (0.1 * rng.standard_normal((2, jax_whisper.CHUNK_SAMPLES))).astype(np.float32)
    chunks[1, 11 * 16000 :] = 0.0
    ref = np.asarray(
        jax_whisper.encode_mel_chunks(
            jax_whisper.WhisperEncoder(jax_whisper.WhisperConfig.tiny()), jax_params, jnp.asarray(chunks)
        )
    )
    ours = torch_whisper.encode_mel_chunks(_encoder(jax_params), torch.from_numpy(chunks))
    assert ours.dtype == torch.float32
    assert ours.shape == ref.shape == (2, 1500, 64)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


def test_state_dict_covers_every_parameter(jax_params) -> None:
    state = convert.whisper_encoder_state_dict(jax_params)
    with torch.device("meta"):
        expected = torch_whisper.WhisperEncoder(torch_whisper.WhisperConfig.tiny()).state_dict()
    assert {name: tuple(t.shape) for name, t in state.items()} == {
        name: tuple(t.shape) for name, t in expected.items()
    }
    np.testing.assert_array_equal(
        state["conv1.weight"].numpy(), jax_params["conv1"]["kernel"].transpose(2, 1, 0)
    )
    np.testing.assert_array_equal(
        state["layers.1.mlp_in.weight"].numpy(), jax_params["layer_1"]["mlp_in"]["kernel"].T
    )


def test_bf16_storage_policy(jax_params) -> None:
    encoder = _encoder(jax_params, torch.bfloat16)
    assert {p.dtype for p in encoder.parameters()} == {torch.bfloat16}
    mel = torch.zeros((1, jax_whisper.CHUNK_FRAMES, 80))
    with torch.inference_mode():
        states = encoder(mel)
    assert states.dtype == torch.float32 and torch.isfinite(states).all()


def test_random_init_is_seeded() -> None:
    config = torch_whisper.WhisperConfig.tiny()
    first = torch_whisper.random_whisper_encoder_state(config, seed=5, device="cpu")
    second = torch_whisper.random_whisper_encoder_state(config, seed=5, device="cpu")
    other = torch_whisper.random_whisper_encoder_state(config, seed=6, device="cpu")
    assert all(torch.equal(first[name], second[name]) for name in first)
    assert not torch.equal(first["layers.0.attn.q.weight"], other["layers.0.attn.q.weight"])
    assert torch.equal(first["final_ln.weight"], torch.ones(64))
    assert torch.equal(first["layers.0.mlp_in.bias"], torch.zeros(256))
    bound = 2.0 / np.sqrt(64)
    assert first["layers.0.mlp_in.weight"].abs().max() <= bound


# --------------------------------------------------------------------------- #
# HF checkpoint loader
# --------------------------------------------------------------------------- #

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_whisper_dir(tmp_path_factory):
    cfg = transformers.WhisperConfig(
        vocab_size=320,
        num_mel_bins=80,
        d_model=64,
        encoder_layers=2,
        encoder_attention_heads=4,
        decoder_layers=2,
        decoder_attention_heads=4,
        encoder_ffn_dim=256,
        decoder_ffn_dim=256,
        max_source_positions=48,
        max_target_positions=64,
        activation_function="gelu",
        decoder_start_token_id=1,
        bos_token_id=1,
        eos_token_id=2,
        pad_token_id=0,
    )
    torch.manual_seed(0)
    model = transformers.WhisperModel(cfg).eval()
    out = tmp_path_factory.mktemp("hf_whisper")
    model.save_pretrained(out, safe_serialization=True)
    return out


def _assert_same_tree(ours, ref) -> None:
    assert isinstance(ours, dict) == isinstance(ref, dict)
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for key in ref:
            _assert_same_tree(ours[key], ref[key])
    else:
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_hf_loader_matches_jax_loader(hf_whisper_dir) -> None:
    config = torch_whisper.whisper_config_from_hf_dir(hf_whisper_dir)
    jax_config = jax_whisper.whisper_config_from_hf_dir(hf_whisper_dir)
    assert vars(config) == vars(jax_config)
    ours = torch_whisper.load_hf_whisper_encoder_params(hf_whisper_dir, config)
    ref = jax_whisper.load_hf_whisper_encoder_params(hf_whisper_dir, jax_config)
    _assert_same_tree(ours, ref)


def test_safetensors_reader_matches_library(hf_whisper_dir) -> None:
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    path = next(hf_whisper_dir.glob("*.safetensors"))
    ours = hf_checkpoint.read_safetensors(path)
    ref = safetensors_numpy.load_file(str(path))
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name])


def test_unconsumed_encoder_tensor_refuses_the_load(hf_whisper_dir, tmp_path) -> None:
    """A .bin checkpoint with an extra encoder tensor: both loaders refuse it."""
    state = {
        name: torch.from_numpy(np.array(array))
        for name, array in hf_checkpoint.read_hf_tensors(hf_whisper_dir).items()
    }
    state["encoder.adapter.weight"] = torch.zeros(4, 4)
    torch.save(state, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(
        (hf_whisper_dir / "config.json").read_text(encoding="utf-8"), encoding="utf-8"
    )
    config = torch_whisper.whisper_config_from_hf_dir(tmp_path)
    with pytest.raises(KeyError, match="unconsumed"):
        torch_whisper.load_hf_whisper_encoder_params(tmp_path, config)
    with pytest.raises(KeyError, match="unconsumed"):
        jax_whisper.load_hf_whisper_encoder_params(tmp_path, jax_whisper.whisper_config_from_hf_dir(tmp_path))
    assert json.loads((tmp_path / "config.json").read_text())["d_model"] == 64


def test_encoder_states_match_transformers_whisper_encoder(hf_whisper_dir) -> None:
    """The port's encoder on the HF checkpoint's weights against ``transformers``' own encoder, at 1e-4."""
    config = torch_whisper.whisper_config_from_hf_dir(hf_whisper_dir)
    params = torch_whisper.load_hf_whisper_encoder_params(hf_whisper_dir, config)
    ours = torch_whisper.build_whisper_encoder(
        config, convert.whisper_encoder_state_dict(params), device=torch.device("cpu"), dtype=torch.float32
    )
    reference = transformers.WhisperModel.from_pretrained(hf_whisper_dir).encoder.eval()
    frames = 2 * reference.config.max_source_positions
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal((2, frames, config.n_mels)).astype(np.float32))
    with torch.inference_mode():
        states = ours(mel)
        expected = reference(input_features=mel.transpose(1, 2)).last_hidden_state
    assert states.shape == expected.shape == (2, reference.config.max_source_positions, config.d_model)
    np.testing.assert_allclose(states.numpy(), expected.numpy(), atol=ATOL)
