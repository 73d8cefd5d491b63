"""Consumed-key audit for checkpoint conversion, expected-tensor manifests, staged-checkpoint shapes.

Copied from ``ser_tpu/models/checkpoint_audit.py``: converters read tensors
through :class:`AuditedState`, and any in-scope tensor the conversion never
consumed refuses the load, so a layout variant cannot convert into a model
that silently drops weights. :func:`wav2vec2_manifest`,
:func:`whisper_manifest` and :func:`demucs_manifest` are the expected name →
shape tables of the published HF wav2vec2 and Whisper layouts and of htdemucs,
from config arithmetic alone; :data:`WAV2VEC2_IGNORED` and
:data:`WHISPER_IGNORED` the tensors outside the forward that the loaders
recognize and skip. :func:`read_checkpoint_shapes` reads a staged HF
checkpoint's tensor names and shapes (safetensors headers only, no tensor
data), which the doctor validates against a manifest.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = [
    "WAV2VEC2_IGNORED",
    "WHISPER_IGNORED",
    "AuditedState",
    "CheckpointValidation",
    "TensorManifest",
    "demucs_manifest",
    "read_checkpoint_shapes",
    "unconsumed_key_error",
    "wav2vec2_manifest",
    "whisper_manifest",
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

    def summary(self) -> str:
        if self.ok:
            return "checkpoint layout matches the expected manifest"
        parts = []
        if self.missing:
            parts.append(f"{len(self.missing)} missing (e.g. {', '.join(self.missing[:4])})")
        if self.unexpected:
            parts.append(f"{len(self.unexpected)} unexpected (e.g. {', '.join(self.unexpected[:4])})")
        if self.shape_mismatches:
            name, actual, expected = self.shape_mismatches[0]
            parts.append(
                f"{len(self.shape_mismatches)} shape mismatch(es) (e.g. {name}: {actual} != expected {expected})"
            )
        return "; ".join(parts)


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


#: Fixed sinusoidal table the repo recomputes (`whisper._sinusoids`) plus the
#: output projection HF ties to the token embedding — both recognized, never
#: loaded.
WHISPER_IGNORED: tuple[str, ...] = (
    "encoder.embed_positions.weight",
    "proj_out.weight",
)


def whisper_manifest(config, *, component: str = "model") -> TensorManifest:
    """HF ``WhisperModel`` layout (``openai/whisper-large-v3`` class).

    ``component`` scopes the manifest: ``"encoder"`` / ``"decoder"`` validate
    one subtree (what the split loaders consume), ``"model"`` the full
    checkpoint.
    """
    if component not in ("model", "encoder", "decoder"):
        raise ValueError(f"Unknown whisper manifest component {component!r}.")
    d = config.d_model
    required: dict[str, tuple[int, ...]] = {}

    def attention(base: str) -> None:
        for proj in ("q_proj", "v_proj", "out_proj"):
            required[f"{base}.{proj}.weight"] = (d, d)
            required[f"{base}.{proj}.bias"] = (d,)
        required[f"{base}.k_proj.weight"] = (d, d)  # no bias in whisper K

    def block(base: str, *, cross: bool) -> None:
        attention(f"{base}.self_attn")
        required[f"{base}.self_attn_layer_norm.weight"] = (d,)
        required[f"{base}.self_attn_layer_norm.bias"] = (d,)
        if cross:
            attention(f"{base}.encoder_attn")
            required[f"{base}.encoder_attn_layer_norm.weight"] = (d,)
            required[f"{base}.encoder_attn_layer_norm.bias"] = (d,)
        required[f"{base}.final_layer_norm.weight"] = (d,)
        required[f"{base}.final_layer_norm.bias"] = (d,)
        required[f"{base}.fc1.weight"] = (4 * d, d)
        required[f"{base}.fc1.bias"] = (4 * d,)
        required[f"{base}.fc2.weight"] = (d, 4 * d)
        required[f"{base}.fc2.bias"] = (d,)

    if component in ("model", "encoder"):
        required["encoder.conv1.weight"] = (d, config.n_mels, 3)
        required["encoder.conv1.bias"] = (d,)
        required["encoder.conv2.weight"] = (d, d, 3)
        required["encoder.conv2.bias"] = (d,)
        required["encoder.layer_norm.weight"] = (d,)
        required["encoder.layer_norm.bias"] = (d,)
        for i in range(config.encoder_layers):
            block(f"encoder.layers.{i}", cross=False)
    if component in ("model", "decoder"):
        required["decoder.embed_tokens.weight"] = (config.vocab_size, d)
        required["decoder.embed_positions.weight"] = (
            config.max_target_positions,
            d,
        )
        required["decoder.layer_norm.weight"] = (d,)
        required["decoder.layer_norm.bias"] = (d,)
        for i in range(config.decoder_layers):
            block(f"decoder.layers.{i}", cross=True)

    ignored = list(WHISPER_IGNORED)
    if component == "encoder":
        ignored.append("decoder.")
    elif component == "decoder":
        ignored.append("encoder.")
    return TensorManifest(
        model=f"whisper-{component}",
        required=required,
        ignored=tuple(ignored),
        strip_prefixes=("model.",),
    )


def demucs_manifest(config) -> TensorManifest:
    """Published htdemucs ``state_dict`` layout, shapes from config arithmetic
    (``_demucs_synthetic._shapes``, the one table of the demucs weight names and shapes)."""
    from ser_tpu_torch.models._demucs_synthetic import _shapes

    return TensorManifest(model="demucs_v4", required=dict(_shapes(config)))


def _safetensors_header(path: Path) -> dict[str, tuple[int, ...]]:
    """Tensor names/shapes from a safetensors file's JSON header only."""
    import json
    import struct

    with path.open("rb") as handle:
        (header_len,) = struct.unpack("<Q", handle.read(8))
        header = json.loads(handle.read(header_len))
    return {name: tuple(entry["shape"]) for name, entry in header.items() if name != "__metadata__"}


def read_checkpoint_shapes(model_dir) -> dict[str, tuple[int, ...]]:
    """Tensor names/shapes of a staged HF checkpoint dir.

    safetensors checkpoints are read from headers alone (bytes, not
    gigabytes); ``pytorch_model*.bin`` fall back to a full (weights-only) load.
    """
    model_dir = Path(model_dir)
    safetensor_files = sorted(model_dir.glob("*.safetensors"))
    if safetensor_files:
        shapes: dict[str, tuple[int, ...]] = {}
        for file in safetensor_files:
            shapes.update(_safetensors_header(file))
        return shapes
    from ser_tpu_torch.models.hf_checkpoint import read_hf_tensors

    return {name: tuple(tensor.shape) for name, tensor in read_hf_tensors(model_dir).items()}
