"""Beam search, the teacher-forced alignment pass and beam transcription of the port against ``ser_tpu``.

JAX's own decoder parameters (``WhisperDecoder.init`` at ``WhisperConfig.tiny()``)
are carried across with ``convert.py``; the encoder states are JAX-seeded
float32. Held to the JAX package's functions:

- ``beam_decode_kv_cache`` token for token and length for length at beam
  sizes 1, 3 and 5, with the timestamp rules and suppression on and off, and
  with an end-of-text id the model emits often, so that hypotheses finish and
  the pool, its gate and the length penalty decide the winner;
- beam-1 against greedy, and the finished pool of
  ``test_beam_finished_pool_prefers_eot_terminated_hypothesis``;
- ``alignment_forward`` at ``atol=1e-5, rtol=1e-4`` against JAX's and against
  the greedy loop's own capture (``test_whisper_transcription.py:454``);
- a planted tie in the beam update, which the lowest flat index must win;
- ``transcribe_words(decode_strategy="beam")`` word for word.
"""

from __future__ import annotations

from collections import Counter

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
PREFIX = [200, 202, 203]
EOT = 201
TS_BEGIN = 210


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny decoder, its port, and JAX-seeded encoder states of 2 windows."""
    states = jax.random.normal(jax.random.PRNGKey(3), (2, jax_whisper.CHUNK_FRAMES // 2, CONFIG.d_model), jnp.float32)
    params = jax_whisper.WhisperDecoder(CONFIG).init(
        jax.random.PRNGKey(1), np.zeros((1, CONFIG.max_target_positions), np.int32), states[:1]
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    decoder = torch_whisper.build_whisper_decoder(
        TORCH_CONFIG, convert.whisper_decoder_state_dict(params), device=torch.device("cpu"), dtype=torch.float32
    )
    states = np.array(states)
    greedy, lengths, _ = jax_decode.greedy_decode_kv_cache(
        params, CONFIG, states, jnp.asarray(PREFIX, jnp.int32), jnp.asarray(EOT, jnp.int32), prefix_len=3
    )
    emitted = np.asarray(greedy)[0, 3 : 3 + int(lengths[0])].tolist()
    # Ids the model emits often: declared end-of-text, they make hypotheses finish.
    frequent = [token for token, _ in Counter(emitted).most_common(4)]
    return params, decoder, states, frequent


def _jax_beam(params, states, eot, **kwargs):
    tokens, lengths = jax_decode.beam_decode_kv_cache(
        params, CONFIG, states, jnp.asarray(PREFIX, jnp.int32), jnp.asarray(eot, jnp.int32), prefix_len=3, **kwargs
    )
    return np.asarray(tokens), np.asarray(lengths)


def _torch_beam(decoder, states, eot, **kwargs):
    tokens, lengths = torch_decode.beam_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states), PREFIX, eot, prefix_len=3, **kwargs
    )
    return tokens.numpy(), lengths.numpy()


@pytest.mark.parametrize("beam_size", [1, 3, 5])
@pytest.mark.parametrize("rules", ["plain", "timestamps+suppression"])
@pytest.mark.parametrize("eot_kind", ["eot", "frequent"])
def test_beam_decode_matches_jax(setup, beam_size, rules, eot_kind) -> None:
    params, decoder, states, frequent = setup
    kwargs = dict(beam_size=beam_size, length_penalty=1.0 if beam_size != 5 else 0.5)
    if rules != "plain":
        kwargs.update(timestamp_begin=TS_BEGIN, suppress_tokens=(5, 6, 7))
    eot = EOT if eot_kind == "eot" else frequent[0]
    ref_tokens, ref_lengths = _jax_beam(params, states, eot, **kwargs)
    ours_tokens, ours_lengths = _torch_beam(decoder, states, eot, **kwargs)
    np.testing.assert_array_equal(ours_lengths, ref_lengths)
    np.testing.assert_array_equal(ours_tokens, ref_tokens)


@pytest.mark.parametrize("index", [1, 3])
def test_finished_hypotheses_decide_the_winner_as_in_jax(setup, index) -> None:
    """Declared end-of-text ids that finish hypotheses early in one window and late in the other."""
    params, decoder, states, frequent = setup
    for beam_size in (3, 5):
        ref_tokens, ref_lengths = _jax_beam(params, states, frequent[index], beam_size=beam_size)
        ours_tokens, ours_lengths = _torch_beam(decoder, states, frequent[index], beam_size=beam_size)
        np.testing.assert_array_equal(ours_lengths, ref_lengths)
        np.testing.assert_array_equal(ours_tokens, ref_tokens)
        assert ours_lengths.min() < TORCH_CONFIG.max_target_positions - 3 - 1  # a hypothesis finished


def test_beam_size_one_matches_greedy(setup) -> None:
    _, decoder, states, _ = setup
    greedy, g_len, _ = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states), PREFIX, EOT, prefix_len=3
    )
    beam, b_len = _torch_beam(decoder, states, EOT, beam_size=1)
    np.testing.assert_array_equal(b_len, g_len.numpy())
    for row in range(2):
        n = int(g_len[row])
        np.testing.assert_array_equal(beam[row, 3 : 3 + n], greedy[row, 3 : 3 + n].numpy())


def test_beam_finished_pool_prefers_eot_terminated_hypothesis(setup) -> None:
    """The JAX test's case: greedy stops at a declared EOT, and beam-1's pool returns that prefix."""
    params, decoder, states, _ = setup
    g_tokens, g_len, _ = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states[:1]), PREFIX, EOT, prefix_len=3
    )
    emitted = g_tokens[0, 3 : 3 + int(g_len[0])].tolist()
    eot_id = next(t for t in emitted[1:] if t != emitted[0])
    g2_tokens, g2_len, _ = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states[:1]), PREFIX, eot_id, prefix_len=3
    )
    b_tokens, b_len = _torch_beam(decoder, states[:1], eot_id, beam_size=1)
    ref_tokens, ref_len = _jax_beam(params, states[:1], eot_id, beam_size=1)
    n = int(g2_len[0])
    assert int(b_len[0]) == int(ref_len[0]) == n
    assert b_tokens[0, 3 : 3 + n].tolist() == g2_tokens[0, 3 : 3 + n].tolist()
    assert (b_tokens[0, 3 + n :] == eot_id).all()
    np.testing.assert_array_equal(b_tokens, ref_tokens)


def test_planted_tie_goes_to_the_lowest_flat_index(setup, monkeypatch) -> None:
    """Every step's logits tie across the whole vocabulary: jax.lax.top_k keeps
    the lowest flat index first, so every beam descends from beam 0 and the
    winner emits id 0 at every step. The port must agree (torch.topk promises
    no order among ties); both packages run the same planted step."""
    import dataclasses

    params, decoder, states, _ = setup
    vocab = TORCH_CONFIG.vocab_size
    config16 = dataclasses.replace(CONFIG, max_target_positions=16)  # a fresh trace for the planted JAX step

    def flat_torch_step(params, weights, cross_k, cross_v, self_k, self_v, token_ids, position, **kwargs):
        return torch.zeros((token_ids.shape[0], vocab)), []

    def flat_jax_step(params, qkv, cross_k, cross_v, self_k, self_v, token_ids, position, **kwargs):
        return jnp.zeros((token_ids.shape[0], vocab), jnp.float32), self_k, self_v, []

    monkeypatch.setattr(torch_decode, "_decoder_token_step", flat_torch_step)
    monkeypatch.setattr(jax_decode, "_decoder_token_step", flat_jax_step)
    ours, ours_len = torch_decode.beam_decode_kv_cache(
        decoder, dataclasses.replace(TORCH_CONFIG, max_target_positions=16), torch.from_numpy(states[:1]),
        PREFIX, EOT, prefix_len=3, beam_size=4,
    )
    ref, ref_len = jax_decode.beam_decode_kv_cache(
        params, config16, states[:1], jnp.asarray(PREFIX, jnp.int32), jnp.asarray(EOT, jnp.int32),
        prefix_len=3, beam_size=4,
    )
    assert ours[0, 3:].tolist() == [0] * 13 and int(ours_len[0]) == 13
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours_len.numpy(), np.asarray(ref_len))


def test_alignment_forward_matches_jax_and_the_loop_capture(setup) -> None:
    params, decoder, states, _ = setup
    spec = ((1, 0), (1, 2))
    tokens, lengths, loop_align = torch_decode.greedy_decode_kv_cache(
        decoder, TORCH_CONFIG, torch.from_numpy(states), PREFIX, EOT, prefix_len=3, align_spec=spec
    )
    forced = torch_decode.alignment_forward(decoder, TORCH_CONFIG, torch.from_numpy(states), tokens, align_spec=spec)
    ref = np.asarray(jax_decode.alignment_forward(params, CONFIG, states, tokens.numpy().astype(np.int32), align_spec=spec))
    assert forced.shape == ref.shape == (2, 2, TORCH_CONFIG.max_target_positions, states.shape[1])
    np.testing.assert_allclose(forced.numpy(), ref, atol=1e-5, rtol=1e-4)
    n_rows = min(3 + int(lengths[0]), TORCH_CONFIG.max_target_positions - 1)
    np.testing.assert_allclose(forced[0, :, :n_rows].numpy(), loop_align[0, :, :n_rows].numpy(), atol=1e-5, rtol=1e-4)


def test_alignment_forward_refuses_out_of_range_heads(setup) -> None:
    _, decoder, states, _ = setup
    with pytest.raises(ValueError, match="out of range"):
        torch_decode.alignment_forward(
            decoder, TORCH_CONFIG, torch.from_numpy(states), torch.zeros((1, 8), dtype=torch.long), align_spec=((0, 99),)
        )


def test_fused_beam_step_is_refused(setup) -> None:
    _, decoder, states, _ = setup
    weights = torch_decode.prepare_decode_weights(decoder, TORCH_CONFIG, fused=True)
    with pytest.raises(ValueError, match=r"greedy \(beams == 1\) only"):
        torch_decode._decoder_token_step(
            decoder, weights, [], [], [], [], torch.zeros(3, dtype=torch.long), 0,
            config=TORCH_CONFIG, compute_dtype=torch.float32, beams=3, fused=True,
        )


class TinyTokenizer:
    SPECIALS = {"<|startoftranscript|>": 200, "<|endoftext|>": 201, "<|en|>": 202, "<|transcribe|>": 203, "<|0.00|>": 210}
    unk_token_id = 199

    def convert_tokens_to_ids(self, tokens):
        return [self.SPECIALS.get(token, self.unk_token_id) for token in tokens]

    def decode(self, ids):
        return "".join(f" t{i}" for i in ids)


@pytest.fixture(scope="module")
def beam_models():
    encoder_params = jax.tree_util.tree_map(np.asarray, jax_whisper.init_whisper_encoder_params(CONFIG, seed=0))
    decoder_params = jax_whisper.WhisperDecoder(CONFIG).init(
        jax.random.PRNGKey(1),
        np.zeros((1, CONFIG.max_target_positions), np.int32),
        np.zeros((1, jax_whisper.CHUNK_FRAMES // 2, CONFIG.d_model), np.float32),
    )["params"]
    decoder_params = jax.tree_util.tree_map(np.asarray, decoder_params)
    rng = np.random.default_rng(5)
    decoder_params["pos_embed"] = (0.05 * rng.standard_normal(decoder_params["pos_embed"].shape)).astype(np.float32)
    options = dict(decode_strategy="beam", beam_size=3, length_penalty=1.0)
    reference = jax_whisper.WhisperForTranscription(
        CONFIG, encoder_params, decoder_params, TinyTokenizer(), compute_dtype="float32", **options
    )
    ported = torch_whisper.WhisperForTranscription(
        TORCH_CONFIG, convert.whisper_encoder_state_dict(encoder_params),
        convert.whisper_decoder_state_dict(decoder_params), TinyTokenizer(), device="cpu", **options
    )
    reference.RETRY_TEMPERATURES = ported.RETRY_TEMPERATURES = ()
    return reference, ported


def _speechlike(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * t / 3.0)
    return (0.3 * envelope * (np.sin(2 * np.pi * 190 * t) + 0.3 * rng.standard_normal(t.size))).astype(np.float32)


@pytest.mark.parametrize("word_timestamps", ["align", "interpolate"])
def test_transcribe_words_beam_matches_jax(beam_models, word_timestamps) -> None:
    reference, ported = beam_models
    reference.word_timestamps = ported.word_timestamps = word_timestamps
    try:
        audio = _speechlike(42.0, seed=3)
        ref = reference.transcribe_words(audio, use_vad=False)
        ours = ported.transcribe_words(audio, use_vad=False)
    finally:
        reference.word_timestamps = ported.word_timestamps = "align"
    assert len(ours) > 10
    assert [w.word for w in ours] == [w.word for w in ref]
    for a, b in zip(ours, ref):
        assert abs(a.start_seconds - b.start_seconds) <= 1e-6
        assert abs(a.end_seconds - b.end_seconds) <= 1e-6
    starts = [w.start_seconds for w in ours]
    assert starts == sorted(starts) and all(w.end_seconds > w.start_seconds for w in ours)


def test_beam_retries_sample_through_the_greedy_route(beam_models, monkeypatch) -> None:
    """A retry above temperature 0 never runs the beam loop (the JAX package's rule)."""
    _, ported = beam_models
    calls = []
    real_beam, real_greedy = torch_decode.beam_decode_kv_cache, torch_decode.greedy_decode_kv_cache
    monkeypatch.setattr(torch_decode, "beam_decode_kv_cache", lambda *a, **k: calls.append("beam") or real_beam(*a, **k))
    monkeypatch.setattr(
        torch_decode, "greedy_decode_kv_cache", lambda *a, **k: calls.append(("greedy", k["fused"])) or real_greedy(*a, **k)
    )
    states = torch.zeros((1, jax_whisper.CHUNK_FRAMES // 2, CONFIG.d_model))
    ported._decode_chunk_batch(states, "en", np.array([100]))
    ported._decode_chunk_batch(states, "en", np.array([100]), temperature=0.5, rng_seed=1)
    assert calls == ["beam", ("greedy", True)]
