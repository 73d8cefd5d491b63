"""Consumed-key audit for checkpoint conversion, and the wav2vec2 manifest.

Copied from ``ser_tpu/models/checkpoint_audit.py`` (the parts the Whisper and
wav2vec2 loaders use): converters read tensors through :class:`AuditedState`,
and any in-scope tensor the conversion never consumed refuses the load, so a
layout variant cannot convert into a model that silently drops weights.
:func:`wav2vec2_manifest` is the expected name → shape table of the published
HF wav2vec2 layout, and :data:`WAV2VEC2_IGNORED` the pretraining and task
heads outside the encoder that the wav2vec2 loader recognizes and skips.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np

__all__ = [
    "WAV2VEC2_IGNORED",
    "AuditedState",
    "CheckpointValidation",
    "TensorManifest",
    "unconsumed_key_error",
    "wav2vec2_manifest",
]


class AuditedState:
    """Tracks which checkpoint tensors a conversion actually consumed.

    The converter reads through :meth:`take` (and tests presence with ``in``);
    :meth:`unconsumed` afterwards names the tensors it never looked at, so a
    layout variant that only ADDS keys fails loudly instead of converting into
    a forward that silently omits those weights.
    """

    def __init__(self, state: Mapping[str, np.ndarray]):
        self._state = dict(state)
        self.consumed: set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self._state

    def take(self, key: str) -> np.ndarray:
        """Reads one tensor; raises ``KeyError`` naming it when missing."""
        if key not in self._state:
            raise KeyError(f"Missing weight {key!r} in checkpoint.")
        self.consumed.add(key)
        return np.asarray(self._state[key])

    def unconsumed(
        self,
        *,
        scope_prefixes: tuple[str, ...] | None = None,
        ignore_exact: tuple[str, ...] = (),
        ignore_prefixes: tuple[str, ...] = (),
    ) -> list[str]:
        """Names every in-scope tensor that no read touched.

        ``scope_prefixes`` restricts the audit to one subtree (the encoder
        loader must not flag decoder tensors); ``ignore_exact`` and
        ``ignore_prefixes`` name documented-benign leftovers (a fixed position
        table, pretraining heads).
        """
        return sorted(
            key
            for key in self._state
            if key not in self.consumed
            and (scope_prefixes is None or key.startswith(scope_prefixes))
            and key not in ignore_exact
            and not key.startswith(ignore_prefixes)
        )


def unconsumed_key_error(leftovers: list[str], *, model: str) -> KeyError:
    """The error that refuses a partial conversion, naming a few leftovers."""
    preview = ", ".join(leftovers[:8])
    return KeyError(
        f"{model} checkpoint layout variant not understood: {len(leftovers)} "
        f"unconsumed tensor(s) (e.g. {preview}). Refusing to load a partial "
        "conversion — the dropped weights would silently change the model."
    )


@dataclass(frozen=True)
class CheckpointValidation:
    """Result of matching a checkpoint's tensors against a manifest."""

    missing: tuple[str, ...]
    unexpected: tuple[str, ...]
    #: (name, actual shape, expected shape) triples.
    shape_mismatches: tuple[tuple[str, tuple[int, ...], tuple[int, ...]], ...]

    @property
    def ok(self) -> bool:
        return not (self.missing or self.unexpected or self.shape_mismatches)


@dataclass(frozen=True)
class TensorManifest:
    """Expected tensor names/shapes for one published checkpoint layout."""

    model: str
    required: dict[str, tuple[int, ...]]
    #: Exactly one group must be fully present (on-disk layout variants, e.g.
    #: the three weight-norm encodings of the wav2vec2 pos-conv kernel).
    alternative_groups: tuple[dict[str, tuple[int, ...]], ...] = ()
    #: Recognized-but-unchecked names: entries ending in ``.`` match as
    #: prefixes, others exactly.
    ignored: tuple[str, ...] = ()
    #: Key prefixes stripped from checkpoint names before matching.
    strip_prefixes: tuple[str, ...] = ()

    def _normalize(self, name: str) -> str:
        for prefix in self.strip_prefixes:
            if name.startswith(prefix):
                return name[len(prefix) :]
        return name

    def _is_ignored(self, name: str) -> bool:
        return any(name.startswith(entry) if entry.endswith(".") else name == entry for entry in self.ignored)

    def validate(self, actual: Mapping[str, tuple[int, ...]]) -> CheckpointValidation:
        """Matches normalized checkpoint names/shapes against this manifest."""
        normalized = {self._normalize(name): tuple(int(d) for d in shape) for name, shape in actual.items()}
        known: dict[str, tuple[int, ...]] = dict(self.required)
        for group in self.alternative_groups:
            known.update(group)
        missing = [name for name in self.required if name not in normalized]
        if self.alternative_groups and not any(
            all(name in normalized for name in group) for group in self.alternative_groups
        ):
            best = max(self.alternative_groups, key=lambda group: sum(name in normalized for name in group))
            missing.extend(name for name in best if name not in normalized)
        unexpected = [name for name in normalized if name not in known and not self._is_ignored(name)]
        mismatches = [
            (name, normalized[name], known[name])
            for name in normalized
            if name in known and normalized[name] != known[name]
        ]
        return CheckpointValidation(
            missing=tuple(sorted(missing)),
            unexpected=tuple(sorted(unexpected)),
            shape_mismatches=tuple(sorted(mismatches)),
        )


#: Tensors in published wav2vec2 exports that sit outside the encoder's
#: forward: the XLS-R pretraining heads (quantizer, projections, the
#: SpecAugment mask embedding) and task heads on top of the encoder (CTC
#: ``lm_head``, classification heads). HF's ``Wav2Vec2Model`` load drops them
#: too. Adapter layers are not here: they change the encoder's output and must
#: refuse the load.
WAV2VEC2_IGNORED: tuple[str, ...] = (
    "masked_spec_embed",
    "quantizer.",
    "project_q.",
    "project_hid.",
    "lm_head.",
    "classifier.",
    "projector.",
)


def wav2vec2_manifest(config) -> TensorManifest:
    """HF ``Wav2Vec2Model`` layout (``facebook/wav2vec2-xls-r-300m`` class).

    Shapes follow torch conventions (``weight`` is (out, in) for linear,
    (out, in, k) for conv).
    """
    hidden = config.hidden_size
    inter = config.intermediate_size
    required: dict[str, tuple[int, ...]] = {}
    for i, dim in enumerate(config.conv_dim):
        chin = 1 if i == 0 else config.conv_dim[i - 1]
        base = f"feature_extractor.conv_layers.{i}"
        required[f"{base}.conv.weight"] = (dim, chin, config.conv_kernel[i])
        if config.feat_extract_norm == "layer":
            required[f"{base}.conv.bias"] = (dim,)
        if config.feat_extract_norm == "layer" or i == 0:
            required[f"{base}.layer_norm.weight"] = (dim,)
            required[f"{base}.layer_norm.bias"] = (dim,)
    last_conv = config.conv_dim[-1]
    required["feature_projection.layer_norm.weight"] = (last_conv,)
    required["feature_projection.layer_norm.bias"] = (last_conv,)
    required["feature_projection.projection.weight"] = (hidden, last_conv)
    required["feature_projection.projection.bias"] = (hidden,)
    pos_base = "encoder.pos_conv_embed.conv"
    kernel = config.num_conv_pos_embeddings
    v_shape = (hidden, hidden // config.num_conv_pos_embedding_groups, kernel)
    g_shape = (1, 1, kernel)
    required[f"{pos_base}.bias"] = (hidden,)
    alternative_groups = (
        {f"{pos_base}.weight": v_shape},
        {f"{pos_base}.weight_g": g_shape, f"{pos_base}.weight_v": v_shape},
        {
            f"{pos_base}.parametrizations.weight.original0": g_shape,
            f"{pos_base}.parametrizations.weight.original1": v_shape,
        },
    )
    required["encoder.layer_norm.weight"] = (hidden,)
    required["encoder.layer_norm.bias"] = (hidden,)
    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            required[f"{base}.attention.{proj}.weight"] = (hidden, hidden)
            required[f"{base}.attention.{proj}.bias"] = (hidden,)
        for ln in ("layer_norm", "final_layer_norm"):
            required[f"{base}.{ln}.weight"] = (hidden,)
            required[f"{base}.{ln}.bias"] = (hidden,)
        required[f"{base}.feed_forward.intermediate_dense.weight"] = (inter, hidden)
        required[f"{base}.feed_forward.intermediate_dense.bias"] = (inter,)
        required[f"{base}.feed_forward.output_dense.weight"] = (hidden, inter)
        required[f"{base}.feed_forward.output_dense.bias"] = (hidden,)
    return TensorManifest(
        model="wav2vec2",
        required=required,
        alternative_groups=alternative_groups,
        ignored=WAV2VEC2_IGNORED,
        strip_prefixes=("wav2vec2.",),
    )
