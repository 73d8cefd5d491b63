"""Whisper decoder and KV-cache greedy decode of the port against ``ser_tpu``.

JAX's own decoder parameters (``WhisperDecoder.init`` at ``WhisperConfig.tiny()``)
are carried across with ``convert.py``; inputs are numpy-seeded float32. The
tolerances are the JAX package's: teacher-forced logits at 1e-4, the fused
(kernel) route against the route through separate ops at 1e-5 per step, and
greedy decodes token for token, with suppression and timestamp rules on, on
both of the port's routes against JAX's default route. The HF decoder loader
gives JAX's tree, and the teacher-forced logits also match ``transformers``'
torch Whisper on the same checkpoint at 1e-4.
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
ENC_LEN = 48
BATCH = 2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    states = rng.standard_normal((BATCH, ENC_LEN, CONFIG.d_model)).astype(np.float32)
    tokens0 = np.zeros((1, CONFIG.max_target_positions), dtype=np.int32)
    params = jax_whisper.WhisperDecoder(CONFIG).init(
        jax.random.PRNGKey(0), tokens0, np.zeros((1, ENC_LEN, CONFIG.d_model), np.float32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # flax initializes the position table to zeros; give it values so positions matter.
    params["pos_embed"] = (0.05 * rng.standard_normal(params["pos_embed"].shape)).astype(np.float32)
    decoder = torch_whisper.build_whisper_decoder(
        TORCH_CONFIG, convert.whisper_decoder_state_dict(params), device=torch.device("cpu"), dtype=torch.float32
    )
    return params, decoder, states


def test_teacher_forced_logits_match_jax(setup) -> None:
    params, decoder, states = setup
    tokens = np.random.default_rng(1).integers(0, CONFIG.vocab_size, size=(BATCH, 12)).astype(np.int32)
    ref = np.asarray(jax_whisper.WhisperDecoder(CONFIG).apply({"params": params}, tokens, states))
    with torch.no_grad():
        ours = decoder(torch.from_numpy(tokens).long(), torch.from_numpy(states))
    assert ours.shape == ref.shape == (BATCH, 12, CONFIG.vocab_size)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_state_dict_covers_every_decoder_parameter(setup) -> None:
    params, _, _ = setup
    state = convert.whisper_decoder_state_dict(params)
    with torch.device("meta"):
        expected = torch_whisper.WhisperDecoder(TORCH_CONFIG).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in expected.items()}
    assert "layers.0.attn.k.bias" not in state and "layers.1.cross.k.bias" not in state


def test_random_decoder_init_is_seeded() -> None:
    first = torch_whisper.random_whisper_decoder_state(TORCH_CONFIG, seed=3)
    second = torch_whisper.random_whisper_decoder_state(TORCH_CONFIG, seed=3)
    assert all(torch.equal(first[name], second[name]) for name in first)
    assert torch.equal(first["pos_embed"], torch.zeros_like(first["pos_embed"]))
    assert abs(first["tok_embed"].std().item() - 0.02) < 0.002


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_timestamp_rules_matches_jax(seed: int) -> None:
    rng = np.random.default_rng(seed)
    batch, vocab, eot, ts_begin = 6, 96, 40, 50
    logits = (3.0 * rng.standard_normal((batch, vocab))).astype(np.float32)
    # Mix rows that favour timestamps with rows that favour text.
    logits[::2, ts_begin:] += 2.0
    last = rng.integers(0, vocab, size=batch)
    last[:3] = [ts_begin + 4, 7, ts_begin + 9]
    penult = rng.integers(0, vocab, size=batch)
    penult[:3] = [3, ts_begin + 2, ts_begin + 1]
    max_ts = np.maximum(last, ts_begin).astype(np.int64)
    counts = np.array([0, 1, 2, 3, 5, 9])
    kwargs = dict(eot=eot, timestamp_begin=ts_begin, max_initial_timestamp_index=10)
    ref = jax_decode.apply_timestamp_rules(
        jnp.asarray(logits), last_token=jnp.asarray(last), penultimate_token=jnp.asarray(penult),
        max_timestamp=jnp.asarray(max_ts), generated_count=jnp.asarray(counts), **kwargs,
    )
    ours = torch_decode.apply_timestamp_rules(
        torch.from_numpy(logits), last_token=torch.from_numpy(last), penultimate_token=torch.from_numpy(penult),
        max_timestamp=torch.from_numpy(max_ts), generated_count=torch.from_numpy(counts), **kwargs,
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _jax_steps(params, states, steps=3):
    cross_k, cross_v = jax_decode._precompute_cross_kv(params, jnp.asarray(states), 2, CONFIG.n_heads, jnp.float32)
    qkv = jax_decode._fuse_qkv_params(params, 2, CONFIG.d_model)
    head_dim = CONFIG.d_model // CONFIG.n_heads
    max_len = CONFIG.max_target_positions
    self_k = [jnp.zeros((BATCH, CONFIG.n_heads, head_dim, max_len)) for _ in range(2)]
    self_v = [jnp.zeros((BATCH, CONFIG.n_heads, max_len, head_dim)) for _ in range(2)]
    token_ids = jnp.asarray([1, 2], dtype=jnp.int32)
    outs = []
    for position in range(steps):
        logits, self_k, self_v, align = jax_decode._decoder_token_step(
            params, qkv, cross_k, cross_v, self_k, self_v, token_ids, jnp.asarray(position, dtype=jnp.int32),
            config=CONFIG, compute_dtype=jnp.float32, align_spec=((0, 1), (1, 2)),
        )
        outs.append((np.asarray(logits), [np.asarray(row) for row in align]))
        token_ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return outs, [np.asarray(k) for k in self_k], [np.asarray(v) for v in self_v]


@torch.inference_mode()
def _torch_steps(decoder, states, *, fused, steps=3):
    weights = torch_decode.prepare_decode_weights(decoder, TORCH_CONFIG, fused=fused)
    cross_k, cross_v = torch_decode._precompute_cross_kv(decoder, torch.from_numpy(states), 2, CONFIG.n_heads, torch.float32)
    head_dim = CONFIG.d_model // CONFIG.n_heads
    max_len = CONFIG.max_target_positions
    self_k = [torch.zeros((BATCH, CONFIG.n_heads, head_dim, max_len)) for _ in range(2)]
    self_v = [torch.zeros((BATCH, CONFIG.n_heads, max_len, head_dim)) for _ in range(2)]
    token_ids = torch.tensor([1, 2])
    outs = []
    for position in range(steps):
        logits, align = torch_decode._decoder_token_step(
            decoder, weights, cross_k, cross_v, self_k, self_v, token_ids, position,
            config=TORCH_CONFIG, compute_dtype=torch.float32, align_spec=((0, 1), (1, 2)), fused=fused,
        )
        outs.append((logits.numpy(), [row.numpy() for row in align]))
        token_ids = torch.argmax(logits, dim=-1)
    return outs, [k.numpy() for k in self_k], [v.numpy() for v in self_v]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decoder_steps_match_jax(setup, fused: bool) -> None:
    params, decoder, states = setup
    ref, ref_k, ref_v = _jax_steps(params, states)
    got, got_k, got_v = _torch_steps(decoder, states, fused=fused)
    for (ref_logits, ref_align), (got_logits, got_align) in zip(ref, got):
        np.testing.assert_allclose(got_logits, ref_logits, rtol=1e-5, atol=1e-5)
        for ref_row, got_row in zip(ref_align, got_align):
            np.testing.assert_allclose(got_row, ref_row, rtol=1e-5, atol=1e-6)
    for layer in range(2):
        np.testing.assert_allclose(got_k[layer], ref_k[layer], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_v[layer], ref_v[layer], rtol=1e-5, atol=1e-6)


def test_fused_steps_match_unfused_steps(setup) -> None:
    _, decoder, states = setup
    unfused, unfused_k, _ = _torch_steps(decoder, states, fused=False)
    fused, fused_k, _ = _torch_steps(decoder, states, fused=True)
    for (a_logits, a_align), (b_logits, b_align) in zip(unfused, fused):
        np.testing.assert_allclose(b_logits, a_logits, rtol=1e-5, atol=1e-5)
        for a_row, b_row in zip(a_align, b_align):
            np.testing.assert_allclose(b_row, a_row, rtol=1e-5, atol=1e-6)
    for a, b in zip(unfused_k, fused_k):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


GREEDY_CASES = {
    "suppress": dict(suppress_tokens=(7, 9), eot=5, prefix=(1, 2, 3), timestamp_begin=None),
    "timestamps": dict(suppress_tokens=(11, 13), eot=150, prefix=(151, 152, 153), timestamp_begin=160),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_greedy_decode_matches_jax_token_for_token(setup, case: str, fused: bool) -> None:
    params, decoder, states = setup
    spec = GREEDY_CASES[case]
    align_spec = ((0, 1), (1, 3))
    ref_tokens, ref_lengths, ref_align = jax_decode.greedy_decode_kv_cache(
        params, CONFIG, jnp.asarray(states), jnp.asarray(spec["prefix"], dtype=jnp.int32),
        jnp.asarray(spec["eot"], dtype=jnp.int32), prefix_len=3, align_spec=align_spec,
        compute_dtype=jnp.float32, suppress_tokens=spec["suppress_tokens"], timestamp_begin=spec["timestamp_begin"],
    )
    tokens, lengths, align = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states), list(spec["prefix"]), spec["eot"], prefix_len=3,
        align_spec=align_spec, compute_dtype=torch.float32, suppress_tokens=spec["suppress_tokens"],
        timestamp_begin=spec["timestamp_begin"], fused=fused,
    )
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_lengths))
    np.testing.assert_allclose(align.numpy(), np.asarray(ref_align), rtol=1e-5, atol=1e-6)
    if spec["timestamp_begin"] is not None:
        generated = tokens.numpy()[:, 3]
        assert (generated >= spec["timestamp_begin"]).all(), "the first generated token is a timestamp"


def test_budget_below_the_position_table(setup) -> None:
    """A shorter ``max_target_positions`` than the table (the 96-token budget) stops the loop there."""
    import dataclasses

    _, decoder, states = setup
    short = dataclasses.replace(TORCH_CONFIG, max_target_positions=10)
    tokens, lengths, align = torch_decode.greedy_decode_kv_cache(
        decoder, short, torch.from_numpy(states), [1, 2, 3], 5, prefix_len=3, align_spec=((1, 0),)
    )
    assert tokens.shape == (BATCH, 10) and align.shape == (BATCH, 1, 10, ENC_LEN)
    assert (lengths <= 7).all()


def test_temperature_sampling_is_deterministic_per_seed(setup) -> None:
    _, decoder, states = setup
    kwargs = dict(prefix_len=3, temperature=0.8, compute_dtype=torch.float32)
    run = lambda seed: torch_decode.greedy_decode_kv_cache(  # noqa: E731
        decoder, TORCH_CONFIG, torch.from_numpy(states), [1, 2, 3], 5, rng_seed=seed, **kwargs
    )[0]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("num_frames", [[48, 48], [30, 17]])
def test_reduce_alignment_matrix_matches_jax(num_frames) -> None:
    rng = np.random.default_rng(7)
    align = rng.random((2, 3, 16, ENC_LEN)).astype(np.float32)
    counts = np.array([9, 16], dtype=np.int32)
    frames = np.asarray(num_frames, dtype=np.int32)
    ref = jax_decode.reduce_alignment_matrix(jnp.asarray(align), jnp.asarray(counts), jnp.asarray(frames), prefix_len=3)
    ours = torch_decode.reduce_alignment_matrix(
        torch.from_numpy(align), torch.from_numpy(counts).long(), torch.from_numpy(frames).long(), prefix_len=3
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4), (32, 20), (4, 6)])
def test_default_alignment_spec_matches_jax(shape) -> None:
    assert torch_decode.default_alignment_spec(*shape) == jax_decode.default_alignment_spec(*shape)


def test_unported_decode_options_raise(setup) -> None:
    """The int8 stream, once refused, runs through separate ops (its first step's
    logits those of JAX's int8 loop; ``tests/test_torch_decode_int8.py`` holds
    the rest), and the fused kernels refuse it with JAX's words."""
    params, decoder, states = setup
    tokens, lengths, _ = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states), [1, 2, 3], 5, prefix_len=3, quant_int8=True
    )
    ref_tokens, _, _ = jax_decode.greedy_decode_kv_cache(
        params, CONFIG, jnp.asarray(states), jnp.asarray([1, 2, 3], jnp.int32), jnp.asarray(5, jnp.int32),
        prefix_len=3, quant_int8=True,
    )
    assert tuple(tokens.shape) == (BATCH, CONFIG.max_target_positions)
    np.testing.assert_array_equal(tokens.numpy()[:, :4], np.asarray(ref_tokens)[:, :4])
    with pytest.raises(ValueError, match="int8 decode weights"):
        torch_decode.greedy_decode_kv_cache(
            decoder, TORCH_CONFIG, torch.from_numpy(states), [1, 2, 3], 5, prefix_len=3, quant_int8=True, fused=True
        )


# --------------------------------------------------------------------------- #
# HF checkpoint: the decoder loader, and transformers' torch Whisper as a second reference
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def hf_whisper(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=320, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=48, max_target_positions=64, activation_function="gelu",
        decoder_start_token_id=1, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    torch.manual_seed(0)
    model = transformers.WhisperModel(cfg).eval()
    out = tmp_path_factory.mktemp("hf_whisper_decoder")
    model.save_pretrained(out, safe_serialization=True)
    return model, out


def test_hf_decoder_loader_matches_jax_loader(hf_whisper) -> None:
    _, model_dir = hf_whisper
    config = torch_whisper.whisper_config_from_hf_dir(model_dir)
    ours = torch_whisper.load_hf_whisper_decoder_params(model_dir, config)
    ref = jax_whisper.load_hf_whisper_decoder_params(model_dir, jax_whisper.whisper_config_from_hf_dir(model_dir))
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [path for path, _ in flat_ours] == [path for path, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_ours, flat_ref):
        np.testing.assert_array_equal(a, b)


def test_teacher_forced_logits_match_transformers(hf_whisper) -> None:
    model, model_dir = hf_whisper
    config = torch_whisper.whisper_config_from_hf_dir(model_dir)
    params = torch_whisper.load_hf_whisper_decoder_params(model_dir, config)
    decoder = torch_whisper.build_whisper_decoder(
        config, convert.whisper_decoder_state_dict(params), device=torch.device("cpu"), dtype=torch.float32
    )
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, 320, size=(2, 10)))
    states = torch.from_numpy(rng.standard_normal((2, 48, 64)).astype(np.float32))
    with torch.no_grad():
        hidden = model.decoder(input_ids=tokens, encoder_hidden_states=states).last_hidden_state
        ref = hidden @ model.decoder.embed_tokens.weight.T  # the tied output head
        ours = decoder(tokens, states)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-4)
