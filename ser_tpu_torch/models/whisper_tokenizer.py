"""Whisper's byte-level tokenizer, decode side only, without ``transformers``.

The card's machine has no ``transformers`` (as it has no ``safetensors``,
which ``hf_checkpoint.py`` replaces), and the transcript lane needs only the
part of ``transformers.WhisperTokenizer`` that ``ser_tpu`` calls:
``decode``, ``convert_tokens_to_ids``, ``unk_token`` and ``unk_token_id``.
Neither package encodes text, so there is no BPE merge step here.

:meth:`WhisperTokenizer.from_pretrained` reads the files the slow
``WhisperTokenizer.from_pretrained`` of ``transformers`` 4.57 reads from a
checkpoint directory, with its precedence:

* ``vocab.json`` and ``merges.txt`` must exist (``transformers`` fails
  without either); ``merges.txt`` is only checked, since nothing is encoded;
* ``tokenizer_config.json`` gives the special tokens and ``errors``; its
  ``added_tokens_decoder``, when present, is the whole added vocabulary;
* otherwise ``special_tokens_map.json`` overrides the config's special tokens
  and ``added_tokens.json`` gives the added vocabulary;
* a special token that is not an added token yet becomes one: at its
  ``vocab.json`` id, or appended after the vocabulary.

``tokenizer.json`` is not read, as the slow tokenizer ignores it.
``clean_up_tokenization_spaces`` is read by ``transformers`` but never
applied by Whisper's ``decode`` in that version, so it changes nothing here
either (``tests/test_torch_whisper_tokenizer.py`` holds both with it on).
"""

from __future__ import annotations

import json
import re
from collections.abc import Iterable, Sequence
from pathlib import Path

#: ``transformers``'s ``SPECIAL_TOKENS_ATTRIBUTES`` order, which sets the ids of appended special tokens.
_SPECIAL_ATTRIBUTES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_DEFAULT_SPECIALS = {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}
_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map from each byte to a printable character (the alphabet of ``vocab.json``)."""
    printable = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
    printable += list(range(ord("®"), ord("ÿ") + 1))
    chars = printable[:]
    shift = 0
    for byte in range(256):
        if byte not in printable:
            printable.append(byte)
            chars.append(256 + shift)
            shift += 1
    return {byte: chr(char) for byte, char in zip(printable, chars)}


def _content(token) -> str | None:
    """A special token's string: a plain string, or a serialized ``AddedToken``'s ``content``."""
    if isinstance(token, dict):
        return token["content"]
    return token


def _read_json(path: Path):
    return json.loads(path.read_text(encoding="utf-8"))


class WhisperTokenizer:
    """Decodes Whisper ids as ``transformers.WhisperTokenizer`` does (``skip_special_tokens=False``).

    ``vocab`` maps byte-level token strings to ids; ``added`` maps added-token
    ids to their strings, in the order they were read; ``specials`` holds the
    special-token attributes (``unk_token`` and the others) and
    ``additional_special_tokens``.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        added: dict[int, str],
        specials: dict,
        *,
        errors: str = "replace",
    ) -> None:
        self._vocab = dict(vocab)
        self._id_to_token = {index: token for token, index in self._vocab.items()}
        self._byte_decoder = {char: byte for byte, char in bytes_to_unicode().items()}
        self._errors = errors
        self._added_decoder = dict(added)
        self._added_encoder = {token: index for index, token in self._added_decoder.items()}
        self._unk_token = _content(specials.get("unk_token"))
        self._add_missing_specials(specials)

    def _add_missing_specials(self, specials: dict) -> None:
        """Makes every special token an added token, as the slow tokenizer's constructor does."""
        ordered: list[str] = []
        for name in _SPECIAL_ATTRIBUTES:
            token = _content(specials.get(name))
            if token is not None:
                ordered.append(token)
        ordered.extend(_content(token) for token in specials.get("additional_special_tokens") or ())
        seen: set[str] = set()
        missing = []
        for token in ordered:
            if token not in seen:
                seen.add(token)
                if token and token not in self._added_encoder:
                    missing.append(token)
        # ``get_vocab()``: every base id under its current string, then the added tokens.
        current = {self._token_of(index): index for index in range(len(self._vocab))}
        current.update(self._added_encoder)
        next_index = len(current)
        for token in missing:
            if token not in current:
                current[token] = next_index
                next_index += 1
            self._added_decoder[current[token]] = token
            self._added_encoder[token] = current[token]

    @classmethod
    def from_pretrained(cls, model_dir) -> "WhisperTokenizer":
        """The tokenizer of a local HF checkpoint directory; raises if ``vocab.json`` or ``merges.txt`` is missing."""
        model_dir = Path(model_dir)
        for required in ("vocab.json", "merges.txt"):
            if not (model_dir / required).is_file():
                raise FileNotFoundError(f"Whisper tokenizer file {model_dir / required} is missing.")
        config_path = model_dir / "tokenizer_config.json"
        config = _read_json(config_path) if config_path.is_file() else {}
        specials = {name: config.get(name, _DEFAULT_SPECIALS.get(name)) for name in _SPECIAL_ATTRIBUTES}
        specials["additional_special_tokens"] = list(config.get("additional_special_tokens") or ())
        added: dict[int, str] = {}
        if "added_tokens_decoder" in config:
            for index, token in config["added_tokens_decoder"].items():
                added[int(index)] = _content(token)
        else:
            map_path = model_dir / "special_tokens_map.json"
            if map_path.is_file():
                for name, value in _read_json(map_path).items():
                    if name == "additional_special_tokens" and isinstance(value, list):
                        extra = specials["additional_special_tokens"]
                        extra.extend(token for token in map(_content, value) if token not in extra)
                    else:
                        specials[name] = _content(value)
            added_path = model_dir / "added_tokens.json"
            if added_path.is_file():
                for token, index in _read_json(added_path).items():
                    added[int(index)] = token
        return cls(_read_json(model_dir / "vocab.json"), added, specials, errors=config.get("errors", "replace"))

    def _token_of(self, index: int) -> str:
        """An id's token string: the added token's, the vocabulary's, or ``''`` past both."""
        if index in self._added_decoder:
            return self._added_decoder[index]
        return self._id_to_token.get(index, "")

    def _bytes_to_text(self, tokens: list[str]) -> str:
        return bytearray(self._byte_decoder[char] for char in "".join(tokens)).decode("utf-8", errors=self._errors)

    def decode(self, token_ids: Iterable[int]) -> str:
        """The text of ``token_ids``: byte-level runs decoded as UTF-8, added tokens verbatim, timestamps dropped."""
        pieces: list[str] = []
        run: list[str] = []
        for index in token_ids:
            token = self._token_of(int(index))
            if token in self._added_encoder:
                if run:
                    pieces.append(self._bytes_to_text(run))
                    run = []
                pieces.append(token)
            else:
                run.append(token)
        if run:
            pieces.append(self._bytes_to_text(run))
        return _TIMESTAMP.sub("", "".join(pieces))

    def _token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        if token in self._added_encoder:
            return self._added_encoder[token]
        return self._vocab.get(token, self._vocab.get(self._unk_token))

    def convert_tokens_to_ids(self, tokens: str | Sequence[str]) -> int | None | list[int | None]:
        """Ids of token strings; an unknown string maps to the vocabulary's unk id, or ``None`` without one."""
        if isinstance(tokens, str):
            return self._token_to_id(tokens)
        return [self._token_to_id(token) for token in tokens]

    @property
    def unk_token(self) -> str | None:
        return self._unk_token

    @property
    def unk_token_id(self) -> int | None:
        return self._token_to_id(self._unk_token)


__all__ = ["WhisperTokenizer", "bytes_to_unicode"]
