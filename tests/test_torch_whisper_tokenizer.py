"""The port's Whisper tokenizer against ``transformers.WhisperTokenizer``, on the CPU.

``ser_tpu`` loads ``transformers.WhisperTokenizer`` (``ser_tpu/models/
whisper.py``); the port reads the same files itself
(``ser_tpu_torch/models/whisper_tokenizer.py``). Four staged forms:

- ``jax_suite``: the layout the JAX package's checkpoint-loading test writes
  (80 ASCII byte tokens and ``Ġw``, specials in ``added_tokens.json``);
- ``added_tokens_json``: a 700-token byte-level vocabulary with multi-byte
  pieces, the added tokens in ``added_tokens.json`` and the special tokens in
  ``special_tokens_map.json`` (the legacy files);
- ``added_tokens_decoder``: the same vocabulary with large-v3's 1609 added
  tokens in ``tokenizer_config.json``'s ``added_tokens_decoder`` and
  ``clean_up_tokenization_spaces`` on;
- ``large_v3``: ``chip_smoke.write_whisper_tokenizer_files`` at full size
  (50257 byte-level tokens, added tokens from 50257), the files the card
  reads.

Each behaviour is one parametrised test: ``decode`` on seeded id sequences
(split multi-byte UTF-8, ``Ġ`` words and punctuation, special and timestamp
tokens, ids past the vocabulary), ``convert_tokens_to_ids`` (``None`` for an
unknown added-token string), ``unk_token``/``unk_token_id``, and
``word_timing.split_tokens_into_words`` of both packages under both
tokenizers; then the files: a missing ``vocab.json`` or ``merges.txt``
raises in both, a missing ``added_tokens.json`` or ``tokenizer_config.json``
does not, and the results still agree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from ser_tpu.models import word_timing as jax_word_timing  # noqa: E402
from ser_tpu_torch.models import word_timing as torch_word_timing  # noqa: E402
from ser_tpu_torch.models.whisper_tokenizer import WhisperTokenizer, bytes_to_unicode  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parents[1]
FORMS = ("jax_suite", "added_tokens_json", "added_tokens_decoder", "large_v3")
KINDS = ("split_utf8", "words_and_punctuation", "special_and_timestamps", "past_vocabulary")


def _chip_smoke():
    """``chip_smoke.py`` as a module, without leaving its environment default behind: the ``large_v3`` form
    is the files its ``transcript-infer`` phase stages for the card, held here to ``transformers``."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("TEARDOWN_CUPTI", os.environ.get("TEARDOWN_CUPTI", "0"))
        spec = importlib.util.spec_from_file_location("chip_smoke_layout", REPO_ROOT / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


def _write_jax_suite(model_dir: Path) -> None:
    """The tokenizer files of ``tests/suites/integration/transcript/test_whisper_checkpoint_loading.py``."""
    model_dir.mkdir(parents=True)
    vocab = {chr(33 + index): index for index in range(80)}
    vocab["Ġw"] = 80
    (model_dir / "vocab.json").write_text(json.dumps(vocab))
    (model_dir / "merges.txt").write_text("#version: 0.2\n")
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"] + [
        f"<|{i / 100:.2f}|>" for i in range(0, 3001, 2)
    ]
    (model_dir / "added_tokens.json").write_text(json.dumps({token: 81 + i for i, token in enumerate(specials)}))
    (model_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "WhisperTokenizer", "unk_token": "<|endoftext|>",
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
    }))


def _to_legacy(model_dir: Path) -> None:
    """``added_tokens_decoder`` moved out to ``added_tokens.json`` and ``special_tokens_map.json``."""
    config = json.loads((model_dir / "tokenizer_config.json").read_text(encoding="utf-8"))
    added = config.pop("added_tokens_decoder")
    config.pop("clean_up_tokenization_spaces")
    (model_dir / "added_tokens.json").write_text(
        json.dumps({entry["content"]: int(index) for index, entry in added.items()}), encoding="utf-8"
    )
    (model_dir / "special_tokens_map.json").write_text(json.dumps({
        "unk_token": {"content": "<|endoftext|>", "lstrip": False, "normalized": False, "rstrip": False,
                      "single_word": False},
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
        "additional_special_tokens": ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"],
    }), encoding="utf-8")
    (model_dir / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")


def _stage(form: str, root: Path, smoke) -> Path:
    model_dir = root / form
    if form == "jax_suite":
        _write_jax_suite(model_dir)
    else:
        smoke.write_whisper_tokenizer_files(model_dir, n_vocab=50257 if form == "large_v3" else 700, seed=3)
        if form == "added_tokens_json":
            _to_legacy(model_dir)
    return model_dir


def _load_reference(model_dir: Path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return transformers.WhisperTokenizer.from_pretrained(str(model_dir))


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("whisper_tokenizer")
    smoke = _chip_smoke()
    pairs = {}
    for form in FORMS:
        model_dir = _stage(form, root, smoke)
        pairs[form] = (model_dir, WhisperTokenizer.from_pretrained(model_dir), _load_reference(model_dir))
    return pairs


def _pools(model_dir: Path, reference) -> dict[str, list[int]]:
    """Ids grouped by what they exercise, read from the staged files."""
    vocab = json.loads((model_dir / "vocab.json").read_text(encoding="utf-8"))
    byte_decoder = {char: byte for byte, char in bytes_to_unicode().items()}
    partial, words, punctuation = [], [], []
    for token, index in vocab.items():
        raw = bytes(byte_decoder[char] for char in token)
        try:
            raw.decode("utf-8")
        except UnicodeDecodeError:
            partial.append(index)
        if token.startswith("Ġ"):
            words.append(index)
        if raw.decode("utf-8", errors="replace") in ".,!?'\"-:;":
            punctuation.append(index)
    added = sorted(reference.added_tokens_decoder)
    timestamps = [index for index in added if reference.convert_ids_to_tokens(index)[2:3].isdigit()]
    specials = [index for index in added if index not in timestamps]
    total = max(max(vocab.values()), max(added)) + 1
    return {"vocab": sorted(vocab.values()), "partial": partial or sorted(vocab.values()), "words": words,
            "punctuation": punctuation, "specials": specials, "timestamps": timestamps,
            "past": list(range(total, total + 50)) + [-1]}


def _sequences(pools: dict[str, list[int]], kind: str, seed: int, count: int = 40) -> list[list[int]]:
    """Seeded id sequences: mostly the kind's pools, the rest any vocabulary id."""
    mixes = {
        "split_utf8": ("partial",),
        "words_and_punctuation": ("words", "punctuation"),
        "special_and_timestamps": ("specials", "timestamps"),
        "past_vocabulary": ("past",),
    }
    rng = np.random.default_rng(seed)
    sequences = []
    for _ in range(count):
        ids = []
        for _ in range(int(rng.integers(1, 16))):
            mix = pools[mixes[kind][int(rng.integers(len(mixes[kind])))]]
            source = mix if mix and rng.random() >= 0.3 else pools["vocab"]
            ids.append(int(source[int(rng.integers(len(source)))]))
        sequences.append(ids)
    return sequences


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", FORMS)
def test_decode_matches_transformers(staged, form: str, kind: str) -> None:
    model_dir, ours, reference = staged[form]
    pools = _pools(model_dir, reference)
    for ids in _sequences(pools, kind, seed=FORMS.index(form) * 10 + KINDS.index(kind)):
        assert ours.decode(ids) == reference.decode(ids), ids


def test_decode_matches_the_measured_strings(staged) -> None:
    """The strings ``transformers`` 4.57.6 gives on the JAX suite's files: added tokens verbatim with no space,
    the timestamp dropped; an id past the vocabulary decodes to ''."""
    _, ours, reference = staged["jax_suite"]
    for ids, text in (([82, 83, 84, 80, 11, 87, 13], "<|startoftranscript|><|en|><|transcribe|> w,."), ([5000], "")):
        assert ours.decode(ids) == reference.decode(ids) == text


@pytest.mark.parametrize("form", FORMS)
def test_convert_tokens_to_ids_matches_transformers(staged, form: str) -> None:
    model_dir, ours, reference = staged[form]
    vocab = json.loads((model_dir / "vocab.json").read_text(encoding="utf-8"))
    tokens = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>",
              "<|0.00|>", "<|30.00|>", "<|xx|>", "<|yue|>", "", "Ġw", "Ġ", "!", *list(vocab)[-5:]]
    assert ours.convert_tokens_to_ids(tokens) == reference.convert_tokens_to_ids(tokens)
    assert ours.convert_tokens_to_ids(["<|xx|>"]) == reference.convert_tokens_to_ids(["<|xx|>"]) == [None]
    for token in tokens:
        assert ours.convert_tokens_to_ids(token) == reference.convert_tokens_to_ids(token), token


@pytest.mark.parametrize("form", FORMS)
def test_unk_token_matches_transformers(staged, form: str) -> None:
    _, ours, reference = staged[form]
    assert (ours.unk_token, ours.unk_token_id) == (reference.unk_token, reference.unk_token_id)


@pytest.mark.parametrize("form", FORMS)
def test_split_tokens_into_words_matches_under_both_tokenizers(staged, form: str) -> None:
    model_dir, ours, reference = staged[form]
    pools = _pools(model_dir, reference)
    sequences = _sequences(pools, "split_utf8", seed=90 + FORMS.index(form), count=15)
    sequences += _sequences(pools, "words_and_punctuation", seed=95 + FORMS.index(form), count=15)
    for ids in sequences:
        expected = jax_word_timing.split_tokens_into_words(ids, reference)
        assert torch_word_timing.split_tokens_into_words(ids, reference) == expected, ids
        assert torch_word_timing.split_tokens_into_words(ids, ours) == expected, ids


@pytest.mark.parametrize("missing", ["vocab.json", "merges.txt"])
def test_missing_required_file_raises_in_both(staged, tmp_path, missing: str) -> None:
    model_dir = tmp_path / "tokenizer"
    shutil.copytree(staged["added_tokens_decoder"][0], model_dir)
    (model_dir / missing).unlink()
    with pytest.raises(TypeError):
        _load_reference(model_dir)
    with pytest.raises(FileNotFoundError, match=str(model_dir / missing)):
        WhisperTokenizer.from_pretrained(model_dir)


@pytest.mark.parametrize("missing", ["added_tokens.json", "tokenizer_config.json", "special_tokens_map.json"])
def test_optional_file_absent_matches_transformers(staged, tmp_path, missing: str) -> None:
    """Without the file both fall back alike: the unk token appended after the vocabulary, or the defaults."""
    model_dir = tmp_path / "tokenizer"
    shutil.copytree(staged["added_tokens_json"][0], model_dir)
    (model_dir / missing).unlink()
    ours, reference = WhisperTokenizer.from_pretrained(model_dir), _load_reference(model_dir)
    assert (ours.unk_token, ours.unk_token_id) == (reference.unk_token, reference.unk_token_id)
    pools = _pools(model_dir, reference)
    for kind in KINDS:
        for ids in _sequences(pools, kind, seed=7, count=10):
            assert ours.decode(ids) == reference.decode(ids), ids
    tokens = ["<|endoftext|>", "<|en|>", "<|xx|>", "Ġ"]
    assert ours.convert_tokens_to_ids(tokens) == reference.convert_tokens_to_ids(tokens)
