"""The int8 decode weight stream of the port (``SER_DECODE_INT8=1``) against ``ser_tpu``.

JAX's own tiny decoder parameters are carried across with ``convert.py``.
Held to the JAX package's functions on the CPU, where ``torch._int_mm`` and
XLA's int32 ``dot_general`` are both exact:

- ``quantize_decode_weights``: every entry's int8 weights and float32 scales
  bit for bit against the jitted JAX function (the form its decode loops
  run), and each weight within half a quantization step;
- the W8A8 step's logits against JAX's jitted step at 1e-5, and their
  correlation with the float32 step above 0.99
  (``tests/suites/unit/models/test_decode_int8.py``);
- the int8 greedy loop step by step along JAX's own int8 path: JAX's token
  is the port's argmax at every step, or a near-tie within one int8 rounding
  flip (the float32 LayerNorm and GELU differ in the last bit between the
  packages, and a value that close to a rounding boundary rounds apart);
  the beam loop on the int8 stream, and beam-1 against int8 greedy;
- the fused-kernel route refuses the int8 stream with JAX's words;
- ``WhisperForTranscription(decode_int8=True)`` (or ``SER_DECODE_INT8=1``)
  quantizes once and never takes the fused route.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models import whisper as jax_whisper
from ser_tpu.models import whisper_decode as jax_decode
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.models import whisper_decode as torch_decode

CONFIG = jax_whisper.WhisperConfig.tiny()
TORCH_CONFIG = torch_whisper.WhisperConfig.tiny()
ENC_LEN = 16
ENTRIES = ("qkv", "attn_out", "cross_q", "cross_out", "mlp_in", "mlp_out")
#: One int8 rounding flip moves a logit by up to a quantization step of one
#: product's output, a few 1e-3 at this size.
FLIP_BOUND = 2e-2
_JAX_STEP = jax.jit(jax_decode._decoder_token_step, static_argnames=("config", "compute_dtype", "beams", "align_spec", "fused"))


@pytest.fixture(scope="module")
def setup():
    params = jax_whisper.WhisperDecoder(CONFIG).init(
        jax.random.PRNGKey(0),
        np.zeros((1, CONFIG.max_target_positions), np.int32),
        np.zeros((1, ENC_LEN, CONFIG.d_model), np.float32),
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(4)
    params["pos_embed"] = (0.05 * rng.standard_normal(params["pos_embed"].shape)).astype(np.float32)
    decoder = torch_whisper.build_whisper_decoder(
        TORCH_CONFIG, convert.whisper_decoder_state_dict(params), device=torch.device("cpu"), dtype=torch.float32
    )
    qkv = jax_decode._fuse_qkv_params(params, CONFIG.decoder_layers, CONFIG.d_model)
    # Jitted, as the JAX decode loops run it: XLA compiles abs-max / 127 to abs-max × float32(1/127).
    reference = jax.jit(jax_decode.quantize_decode_weights, static_argnums=2)(params, qkv, CONFIG.decoder_layers)
    weights = torch_decode.prepare_decode_weights(decoder, TORCH_CONFIG, fused=False, quant_int8=True)
    return params, decoder, qkv, reference, weights


def test_quantized_weights_match_jax_bit_for_bit(setup) -> None:
    _, _, _, reference, weights = setup
    pairs = [(reference["vocab"], weights.quant["vocab"])]
    for ref_layer, our_layer in zip(reference["layers"], weights.quant["layers"]):
        pairs += [(ref_layer[name], our_layer[name]) for name in ENTRIES]
    for ref, ours in pairs:
        assert ours.w8.dtype == torch.int8 and tuple(ours.w8.shape) == ref["w8"].shape
        np.testing.assert_array_equal(ours.w8.numpy(), np.asarray(ref["w8"]))
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref["scale"]))
        if ref["bias"] is None:
            assert ours.bias is None
        else:
            np.testing.assert_array_equal(ours.bias.numpy(), np.asarray(ref["bias"]))
    assert tuple(weights.quant["vocab"].w8.shape) == (CONFIG.d_model, CONFIG.vocab_size)


def test_quantized_weights_reconstruct_within_half_step(setup) -> None:
    params, _, _, _, weights = setup
    entry = weights.quant["layers"][0]["mlp_in"]
    recon = entry.w8.to(torch.float32) * entry.scale
    err = (recon - torch.tensor(params["layer_0"]["mlp_in"]["kernel"])).abs().max().item()
    assert err <= entry.scale.max().item() * 0.5 + 1e-7


@torch.inference_mode()
def _step(decoder, weights, quant, states, *, fused=False):
    n_layers, heads, max_len = TORCH_CONFIG.decoder_layers, TORCH_CONFIG.n_heads, TORCH_CONFIG.max_target_positions
    head_dim = TORCH_CONFIG.d_model // heads
    cross = torch_decode._precompute_cross_kv(decoder, states, n_layers, heads, torch.float32)
    self_k = [torch.zeros((2, heads, head_dim, max_len)) for _ in range(n_layers)]
    self_v = [torch.zeros((2, heads, max_len, head_dim)) for _ in range(n_layers)]
    logits, _ = torch_decode._decoder_token_step(
        decoder, weights, *cross, self_k, self_v, torch.tensor([1, 2]), 0,
        config=TORCH_CONFIG, compute_dtype=torch.float32, quant=quant, fused=fused,
    )
    return logits


def test_int8_step_logits_match_jax_and_track_float32(setup) -> None:
    params, decoder, qkv, reference, weights = setup
    states = np.random.default_rng(0).standard_normal((2, ENC_LEN, CONFIG.d_model)).astype(np.float32)
    cross_k, cross_v = jax_decode._precompute_cross_kv(params, states, CONFIG.decoder_layers, CONFIG.n_heads, jnp.float32)
    head_dim = CONFIG.d_model // CONFIG.n_heads
    caches = [
        [jnp.zeros((2, CONFIG.n_heads, head_dim, CONFIG.max_target_positions), jnp.float32)] * CONFIG.decoder_layers,
        [jnp.zeros((2, CONFIG.n_heads, CONFIG.max_target_positions, head_dim), jnp.float32)] * CONFIG.decoder_layers,
    ]
    ref, _, _, _ = _JAX_STEP(
        params, qkv, cross_k, cross_v, list(caches[0]), list(caches[1]), jnp.asarray([1, 2], jnp.int32),
        jnp.asarray(0, jnp.int32), config=CONFIG, compute_dtype=jnp.float32, quant=reference,
    )
    ours = _step(decoder, weights, weights.quant, torch.from_numpy(states))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    full = _step(decoder, weights, None, torch.from_numpy(states)).double()
    for row in range(2):
        a, b = full[row] - full[row].mean(), ours[row].double() - ours[row].double().mean()
        assert float(a @ b / (a.norm() * b.norm())) > 0.99


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_int8_greedy_loop_follows_jax_step_by_step(setup, seed) -> None:
    """The port's int8 step, run along the JAX int8 loop's own tokens, picks
    JAX's token at every step, or a near-tie within one int8 rounding flip.

    The two packages' float32 LayerNorm and GELU differ in the last bit (XLA
    fuses them), and an activation within that of a rounding boundary
    rounds to the other int8 value: a logit then moves by up to a
    quantization step, and a near-tie can turn (``ROADMAP.md``, Queue 3).
    Until a flip the logits agree to float32 noise.
    """
    params, decoder, qkv, reference, weights = setup
    states = np.random.default_rng(seed).standard_normal((2, ENC_LEN, CONFIG.d_model)).astype(np.float32)
    prefix, eot = [1, 2, 3], CONFIG.vocab_size - 1
    ref_tokens, ref_lengths, _ = jax_decode.greedy_decode_kv_cache(
        params, CONFIG, states, jnp.asarray(prefix, jnp.int32), jnp.asarray(eot, jnp.int32), prefix_len=3,
        quant_int8=True,
    )
    ref_tokens = np.asarray(ref_tokens)
    head_dim = CONFIG.d_model // CONFIG.n_heads
    shapes = ((2, CONFIG.n_heads, head_dim, CONFIG.max_target_positions), (2, CONFIG.n_heads, CONFIG.max_target_positions, head_dim))
    jax_caches = [[jnp.zeros(shape, jnp.float32)] * CONFIG.decoder_layers for shape in shapes]
    cross_jax = jax_decode._precompute_cross_kv(params, states, CONFIG.decoder_layers, CONFIG.n_heads, jnp.float32)
    torch_caches = [[torch.zeros(shape) for _ in range(CONFIG.decoder_layers)] for shape in shapes]
    gaps, decisions = [], []
    with torch.inference_mode():
        cross = torch_decode._precompute_cross_kv(
            decoder, torch.from_numpy(states), CONFIG.decoder_layers, CONFIG.n_heads, torch.float32
        )
        for position in range(CONFIG.max_target_positions - 1):
            ids = ref_tokens[:, position]
            ref, *jax_caches, _ = _JAX_STEP(
                params, qkv, *cross_jax, list(jax_caches[0]), list(jax_caches[1]), jnp.asarray(ids),
                jnp.asarray(position, jnp.int32), config=CONFIG, compute_dtype=jnp.float32, quant=reference,
            )
            ours, _ = torch_decode._decoder_token_step(
                decoder, weights, *cross, *torch_caches, torch.from_numpy(ids).long(), position,
                config=TORCH_CONFIG, compute_dtype=torch.float32, quant=weights.quant,
            )
            gaps.append(float(np.abs(ours.numpy() - np.asarray(ref)).max()))
            if position + 1 >= 3:
                chosen = torch.from_numpy(ref_tokens[:, position + 1]).long()
                decisions.append((ours.max(dim=-1).values - ours.gather(1, chosen[:, None])[:, 0]).max().item())
    # Each package's caches carry its own roundings, so after a flip later steps differ a little too.
    assert gaps[0] <= 1e-5 and max(gaps) <= FLIP_BOUND
    assert max(decisions) <= FLIP_BOUND  # JAX's token is the port's argmax, or a near-tie within a flip
    assert sum(d > 0 for d in decisions) <= 2


@pytest.mark.parametrize("beam_size", [1, 3])
def test_int8_beam_loop_runs_and_beam_one_is_int8_greedy(setup, beam_size) -> None:
    """The int8 beam loop (the JAX test's case): EOT-padded rows of the budget's
    shape; with one beam it is the int8 greedy decode, token for token."""
    _, decoder, _, _, _ = setup
    states = torch.from_numpy(np.random.default_rng(1).standard_normal((2, ENC_LEN, CONFIG.d_model)).astype(np.float32))
    prefix, eot = [1, 2, 3], CONFIG.vocab_size - 1
    tokens, lengths = torch_decode.beam_decode_kv_cache(
        decoder, TORCH_CONFIG, states, prefix, eot, prefix_len=3, beam_size=beam_size, quant_int8=True
    )
    assert tuple(tokens.shape) == (2, CONFIG.max_target_positions)
    for row in range(2):
        assert (tokens[row, 3 + int(lengths[row]) :] == eot).all()
    if beam_size == 1:
        greedy, g_len, _ = torch_decode.greedy_decode_kv_cache(
            decoder, TORCH_CONFIG, states, prefix, eot, prefix_len=3, quant_int8=True
        )
        assert torch.equal(tokens, greedy) and torch.equal(lengths, g_len)


def test_fused_kernels_refuse_the_int8_stream(setup) -> None:
    _, decoder, _, _, weights = setup
    with pytest.raises(ValueError, match=r"int8 decode weights are XLA-path only \(fused=False\)"):
        _step(decoder, weights, weights.quant, torch.zeros((2, ENC_LEN, CONFIG.d_model)), fused=True)
    with pytest.raises(ValueError, match="int8 decode"):
        torch_decode.greedy_decode_kv_cache(
            decoder, TORCH_CONFIG, torch.zeros((1, ENC_LEN, CONFIG.d_model)), [1, 2, 3], 5, prefix_len=3,
            quant_int8=True, fused=True,
        )


class _Tokenizer:
    SPECIALS = {"<|startoftranscript|>": 200, "<|endoftext|>": 201, "<|en|>": 202, "<|transcribe|>": 203, "<|0.00|>": 210}
    unk_token_id = 199

    def convert_tokens_to_ids(self, tokens):
        return [self.SPECIALS.get(token, self.unk_token_id) for token in tokens]

    def decode(self, ids):
        return "".join(f" t{i}" for i in ids)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_transcription_int8_lane_quantizes_once_and_skips_the_kernels(setup, monkeypatch, strategy) -> None:
    _, decoder, _, _, _ = setup
    monkeypatch.setenv("SER_DECODE_INT8", "1")
    encoder_state = torch_whisper.random_whisper_encoder_state(TORCH_CONFIG, seed=0)
    model = torch_whisper.WhisperForTranscription(
        TORCH_CONFIG, encoder_state, decoder.state_dict(), _Tokenizer(), device="cpu", decode_strategy=strategy,
        beam_size=2,
    )
    assert model.decode_int8
    weights = model.decode_weights()
    assert weights.quant is not None and weights.fused is None and model.decode_weights() is weights
    calls = []
    real = torch_decode._decoder_token_step

    def spy(*args, **kwargs):
        calls.append((kwargs["fused"] if "fused" in kwargs else False, kwargs["quant"] is not None))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_decode, "_decoder_token_step", spy)
    model._decode_chunk_batch(torch.zeros((1, ENC_LEN, CONFIG.d_model)), "en", np.array([ENC_LEN]))
    model._decode_chunk_batch(torch.zeros((1, ENC_LEN, CONFIG.d_model)), "en", np.array([ENC_LEN]), temperature=0.5)
    assert calls and set(calls) == {(False, True)}
