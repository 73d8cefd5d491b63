"""The port's W8A8 ``QuantDense``, the int8 encoder and the int8 runtime row against ``ser_tpu``.

- ``QuantDense`` against ``ser_tpu``'s on the same weights and inputs at
  ``rtol=1e-6, atol=1e-6`` (``tests/suites/unit/models/test_quant_dense.py``),
  with ``nn.Linear``'s state dict, its no-bias form, a zero input, and the
  weights quantized once (again only when the weight tensor changes);
- the tiny Whisper encoder with ``quant_int8`` against ``ser_tpu``'s in
  float32 on JAX's own parameters, and close to the float32 encoder (cosine
  above 0.995, the JAX package's pin). The two int8 encoders agree within
  ``INT8_ENCODER_REL_L2`` (relative L2), under half the quantization's own
  error, which the test also reads: the float32 LayerNorms differ between
  the packages in the last bit (XLA fuses them), and an activation that close
  to a rounding boundary rounds to the other int8 value;
- ``WhisperEncoderBackend(dtype="int8")`` on the CPU against JAX's int8
  encoder in float32, and ``api.infer`` with ``SER_TORCH_DTYPE=int8``;
- the runtime policy's int8 row and its clamp for all four backends;
- ``torch._int_mm``'s rules on the card: an unpadded operand on a CUDA
  tensor raises (the card's check is monkeypatched onto CPU tensors), and the
  padded product equals the exact int32 product.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.config.schema import TorchRuntimeConfig as JaxTorchRuntimeConfig
from ser_tpu._internal.repr import runtime_policy as jax_policy
from ser_tpu.models import whisper as jax_whisper
from ser_tpu.models.quant import QuantDense as JaxQuantDense
from ser_tpu_torch._internal.config.schema import TorchRuntimeConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_feature_runtime
from ser_tpu_torch._internal.repr.whisper_backend import WhisperEncoderBackend
from ser_tpu_torch.models import convert, quant
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.models.quant import QuantDense

TINY = torch_whisper.WhisperConfig.tiny()
#: int8 encoder, port against JAX (both float32 around W8A8), relative L2.
INT8_ENCODER_REL_L2 = 5e-3


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _toy(in_dim=24, out_dim=16, rows=10, seed=0, use_bias=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, in_dim)) * 0.7).astype(np.float32)
    params = JaxQuantDense(out_dim, use_bias=use_bias).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    layer = QuantDense(in_dim, out_dim, bias=use_bias)
    state = {"weight": torch.from_numpy(params["params"]["kernel"].T.copy())}
    if use_bias:
        state["bias"] = torch.from_numpy(rng.standard_normal(out_dim).astype(np.float32) * 0.1)
        params["params"]["bias"] = state["bias"].numpy()
    layer.load_state_dict(state)
    return x, params, layer


@pytest.mark.parametrize(("in_dim", "out_dim", "rows", "seed"), [(24, 16, 10, 11), (96, 64, 64, 5), (64, 256, 3, 2)])
def test_quant_dense_matches_jax(in_dim, out_dim, rows, seed) -> None:
    x, params, layer = _toy(in_dim, out_dim, rows, seed)
    ref = np.asarray(jax.jit(JaxQuantDense(out_dim, dtype=jnp.float32).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = layer(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_state_dict_is_nn_linears_and_no_bias_works() -> None:
    assert set(QuantDense(8, 4).state_dict()) == set(torch.nn.Linear(8, 4).state_dict()) == {"weight", "bias"}
    x, params, layer = _toy(use_bias=False)
    assert set(layer.state_dict()) == {"weight"}
    ref = np.asarray(jax.jit(JaxQuantDense(16, use_bias=False, dtype=jnp.float32).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x), torch.float32).numpy(), ref, rtol=1e-6, atol=1e-6)


def test_zero_input_gives_exactly_the_bias() -> None:
    _, _, layer = _toy()
    with torch.no_grad():
        out = layer(torch.zeros((4, 24)), torch.float32)
    assert torch.equal(out, layer.bias.detach().expand(4, -1))


def test_weights_are_quantized_once_and_again_when_they_change() -> None:
    x, _, layer = _toy()
    first = layer.quantized()
    with torch.no_grad():
        layer(torch.from_numpy(x), torch.float32)
    assert layer.quantized() is first
    with torch.no_grad():
        layer.weight.mul_(2.0)
    second = layer.quantized()
    assert second is not first and torch.allclose(second.scale, 2.0 * first.scale)


def test_int8_matmul_refuses_unpadded_operands_on_the_card(monkeypatch) -> None:
    monkeypatch.setattr(quant, "_on_card", lambda tensor: True)
    a8 = torch.randint(-127, 128, (2, 64), dtype=torch.int8)
    b8 = torch.randint(-127, 128, (64, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="more than 16 rows"):
        quant.int8_matmul(a8, b8)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(torch.zeros((32, 64), dtype=torch.int8), torch.zeros((64, 250), dtype=torch.int8))
    # The padded route the decode takes: 2 rows to 32, 250 output channels stored as 256.
    weight = quant.Int8Weight(torch.randn(64, 250), None)
    assert tuple(weight.padded.shape) == (64, 256) and tuple(weight.w8.shape) == (64, 250)
    out = quant.int8_product(a8, weight)
    assert torch.equal(out, a8.to(torch.int32) @ weight.w8.to(torch.int32))


@pytest.fixture(scope="module")
def tiny_encoder():
    params = jax.tree_util.tree_map(np.asarray, jax_whisper.init_whisper_encoder_params(jax_whisper.WhisperConfig.tiny(), seed=0))
    mel = (np.random.default_rng(0).standard_normal((1, jax_whisper.CHUNK_FRAMES, TINY.n_mels)) * 0.3).astype(np.float32)
    return params, mel


def test_tiny_int8_encoder_matches_jax_and_tracks_float32(tiny_encoder) -> None:
    params, mel = tiny_encoder
    cfg = jax_whisper.WhisperConfig.tiny()
    ref = np.asarray(jax.jit(jax_whisper.WhisperEncoder(cfg, quant_int8=True).apply)({"params": params}, mel))
    state = convert.whisper_encoder_state_dict(params)
    encoder = torch_whisper.build_whisper_encoder(TINY, state, device=torch.device("cpu"), dtype=torch.float32, quant_int8=True)
    assert all(isinstance(getattr(encoder.layers[0].attn, n), QuantDense) for n in "qkv") and isinstance(
        encoder.layers[0].mlp_in, QuantDense
    )
    with torch.no_grad():
        ours = encoder(torch.from_numpy(mel)).numpy()
        full = torch_whisper.build_whisper_encoder(TINY, state, device=torch.device("cpu"), dtype=torch.float32)(
            torch.from_numpy(mel)
        ).numpy()
    assert _rel_l2(ours, ref) <= INT8_ENCODER_REL_L2 < _rel_l2(ours, full) / 2
    a, b = full.ravel(), ours.ravel()
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.995


def test_int8_backend_on_the_cpu_matches_jax(tiny_encoder, tmp_path, monkeypatch) -> None:
    """``dtype="int8"`` on the CPU: float32 around W8A8 products, as JAX's int8 encoder in float32."""
    params, _ = tiny_encoder
    monkeypatch.setenv("SER_ALLOW_RANDOM_INIT", "1")
    backend = WhisperEncoderBackend(model_id="openai/whisper-tiny", cache_root=tmp_path, device=torch.device("cpu"),
                                    dtype="int8")
    state = backend._encoder.state_dict()
    flax_params = convert.flax_whisper_encoder_params(state)
    audio = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)).astype(np.float32)
    encoded = backend.encode_sequence(audio, 16000)
    chunk = np.zeros((1, jax_whisper.CHUNK_SAMPLES), np.float32)
    chunk[0, :16000] = audio
    ref = np.asarray(
        jax_whisper.encode_mel_chunks(jax_whisper.WhisperEncoder(jax_whisper.WhisperConfig.tiny(), quant_int8=True),
                                      flax_params, jnp.asarray(chunk))
    )
    assert _rel_l2(encoded.embeddings, ref[0, : encoded.embeddings.shape[0]]) <= INT8_ENCODER_REL_L2
    assert np.all(np.isfinite(encoded.embeddings))


@pytest.mark.parametrize("backend_id", ["jax_xlsr", "jax_whisper_encoder", "emotion2vec", "handcrafted"])
@pytest.mark.parametrize(("device", "dtype"), [("cuda", "int8"), ("cuda", "w8a8"), ("cpu", "int8"), ("cpu", "w8a8")])
def test_int8_row_and_clamp_match_ser_tpu(monkeypatch, backend_id, device, dtype) -> None:
    """int8 stays int8 for the Whisper encoder (the card and the CPU); elsewhere it
    falls to bf16 on the card and float32 on the CPU, as in the JAX package."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(jax_policy, "_available_kinds", lambda: ("cpu", "tpu"))
    ours = resolve_feature_runtime(backend_id, torch_runtime=TorchRuntimeConfig(device=device, dtype=dtype))
    reference = jax_policy.resolve_feature_runtime(
        backend_id, torch_runtime=JaxTorchRuntimeConfig(device="tpu" if device == "cuda" else "cpu", dtype=dtype)
    )
    assert ours.dtype == reference.dtype
    expected = {"int8": torch.bfloat16 if device == "cuda" else torch.float32, "bfloat16": torch.bfloat16}
    assert ours.torch_dtype == expected.get(ours.dtype, torch.float32)
