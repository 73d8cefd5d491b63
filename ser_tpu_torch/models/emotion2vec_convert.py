"""FunASR/ModelScope emotion2vec checkpoint → the port's ``Wav2Vec2Encoder`` state dict.

Counterpart of ``ser_tpu/models/emotion2vec_convert.py``. emotion2vec
(``iic/emotion2vec_plus_large``) is data2vec 2.0 audio; its ``model.pt``
follows fairseq's multi-modal naming:

- ``modality_encoders.AUDIO.local_encoder.conv_layers.{i}.0.weight``, the
  strided conv front end (a LayerNorm per layer at ``.2.1.*`` in layer-norm
  mode, one GroupNorm at ``conv_layers.0.2.*`` otherwise);
- ``modality_encoders.AUDIO.project_features``: a plain Linear, or
  ``(TransposeLast, LayerNorm, Linear)`` at indices 1 and 2;
- ``modality_encoders.AUDIO.relative_positional_encoder.{i}.0.*``, the
  stacked grouped positional convs (their LayerNorms carry no weights);
- ``modality_encoders.AUDIO.context_encoder.blocks.{i}.*`` (prenet), then
  the trunk's ``blocks.{i}.*``, both AltBlocks (``norm1``, fused
  ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1/fc2``, optional
  layer-scale ``gamma_1/gamma_2``);
- an optional final ``norm.*``.

Prenet and trunk become one flat stack (prenet first); the fused QKV splits
into q, k, v thirds; a layer scale folds into the projection after it, per
output channel (``gamma ⊙ (Wx + b) == (gamma ⊙ W)x + gamma ⊙ b``). The
decoder, EMA teacher and classifier heads are skipped. The config is
inferred from tensor shapes. PyTorch's (out, in[, k]) layouts need no
transposition, so apart from the splits and folds the conversion renames.

``normalize_funasr_state`` does the file-independent half of the load
(envelope, ``model.`` prefix, skipped prefixes, bf16 → float32) on an
in-memory dict, and ``convert_funasr_state`` converts one, so a caller that
holds the tensors converts them without a round trip through a file.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models.checkpoint_audit import AuditedState, unconsumed_key_error
from ser_tpu_torch.models.wav2vec2 import Wav2Vec2Config

logger = get_logger(__name__)

_AUDIO = "modality_encoders.AUDIO."
_SKIP_PREFIXES = ("decoder.", "_ema", "ema.", "proj.", "regression_head.")
_CONV = _AUDIO + "local_encoder.conv_layers."
_POS = _AUDIO + "relative_positional_encoder."
_PRENET = _AUDIO + "context_encoder.blocks."


def normalize_funasr_state(raw: Mapping) -> dict[str, torch.Tensor]:
    """A loaded ``model.pt`` payload → its inference tensors, float32 where they were bf16.

    Unwraps a fairseq envelope (``{"model": {...}}``), strips the ``model.``
    prefix, drops non-tensor entries and the decoder, EMA and head tensors.
    """
    if "model" in raw and isinstance(raw["model"], Mapping):
        raw = raw["model"]
    state: dict[str, torch.Tensor] = {}
    for key, value in raw.items():
        if not isinstance(value, torch.Tensor):
            continue
        if key.startswith("model."):
            key = key[len("model.") :]
        if key.startswith(_SKIP_PREFIXES) or key.startswith(_AUDIO + "decoder."):
            continue
        state[key] = value.float() if value.dtype == torch.bfloat16 else value
    return state


def load_funasr_state_dict(model_dir: str | Path) -> dict[str, torch.Tensor]:
    """Reads ``model.pt`` (``weights_only`` first) and normalizes it."""
    path = Path(model_dir) / "model.pt"
    if not path.is_file():
        raise FileNotFoundError(f"No FunASR checkpoint (model.pt) in {model_dir}.")
    try:
        raw = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:
        # A genuine fairseq envelope carries objects (omegaconf cfg, optimizer
        # state) that the weights_only unpickler refuses. The checkpoint is
        # staged by the operator, trusted as its weights are: retry in full.
        logger.warning("weights_only load of %s failed; retrying with full unpickling (fairseq envelope).", path)
        raw = torch.load(str(path), map_location="cpu", weights_only=False)
    return normalize_funasr_state(raw)


def _count_blocks(state: Mapping, prefix: str) -> int:
    heads = {key[len(prefix) :].split(".", 1)[0] for key in state if key.startswith(prefix)}
    return sum(1 for head in heads if head.isdigit())


def config_from_funasr_state(state: Mapping[str, torch.Tensor]) -> Wav2Vec2Config:
    """Infers the architecture from the checkpoint's tensor shapes."""
    n_convs = _count_blocks(state, _CONV)
    if n_convs == 0:
        raise KeyError("Checkpoint lacks the data2vec-2.0 audio conv frontend.")
    conv_dim = tuple(int(state[f"{_CONV}{i}.0.weight"].shape[0]) for i in range(n_convs))
    conv_kernel = tuple(int(state[f"{_CONV}{i}.0.weight"].shape[2]) for i in range(n_convs))
    # Strides are not serialized; the published data2vec audio front ends use
    # wav2vec2's (5, 2, 2, 2, 2, 2, 2), cut to the layer count.
    conv_stride = tuple(([5] + [2] * (n_convs - 1))[:n_convs])

    if _AUDIO + "project_features.weight" in state:
        hidden = int(state[_AUDIO + "project_features.weight"].shape[0])
        feature_norm = False
    elif _AUDIO + "project_features.2.weight" in state:
        hidden = int(state[_AUDIO + "project_features.2.weight"].shape[0])
        feature_norm = _AUDIO + "project_features.1.weight" in state
    else:
        raise KeyError("Checkpoint lacks project_features.")

    n_prenet = _count_blocks(state, _PRENET)
    n_trunk = _count_blocks(state, "blocks.")
    if n_trunk == 0:
        raise KeyError("Checkpoint lacks trunk transformer blocks.")
    fc1 = state.get("blocks.0.mlp.fc1.weight")
    intermediate = int(fc1.shape[0]) if fc1 is not None else 4 * hidden

    pos_depth = _count_blocks(state, _POS)
    if pos_depth == 0:
        # A positional encoder's weights cannot be invented: refuse here, not
        # with a bare KeyError halfway through the conversion.
        raise KeyError(
            "Checkpoint serializes no relative_positional_encoder blocks; "
            "the data2vec-2.0 conv positional encoder is required."
        )
    pos_weight = state[f"{_POS}0.0.weight"]  # (hidden, hidden / groups, k)
    pos_kernel = int(pos_weight.shape[2])
    return Wav2Vec2Config(
        hidden_size=hidden,
        num_hidden_layers=n_prenet + n_trunk,
        num_attention_heads=max(1, hidden // 64),
        intermediate_size=intermediate,
        conv_dim=conv_dim,
        conv_kernel=conv_kernel,
        conv_stride=conv_stride,
        num_conv_pos_embeddings=pos_kernel * pos_depth,
        num_conv_pos_embedding_groups=max(1, hidden // int(pos_weight.shape[1])),
        feat_extract_norm="layer" if f"{_CONV}0.2.1.weight" in state else "group",
        do_stable_layer_norm=True,
        conv_pos_depth=pos_depth,
        feature_norm_before_projection=feature_norm,
        encoder_norm="norm.weight" in state,
    )


def _tensor(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))


def _block(state: AuditedState, base: str, layer: str, hidden: int) -> dict[str, np.ndarray]:
    """One AltBlock → ``layers.{i}`` tensors (QKV split, layer scales folded)."""

    def optional(key: str) -> np.ndarray | None:
        return state.take(key) if key in state else None

    qkv_w = state.take(f"{base}.attn.qkv.weight")  # (3h, h)
    qkv_b = optional(f"{base}.attn.qkv.bias")
    if qkv_b is None:
        qkv_b = np.zeros(3 * hidden, np.float32)
    out = {f"{layer}.attn_ln.weight": state.take(f"{base}.norm1.weight"),
           f"{layer}.attn_ln.bias": state.take(f"{base}.norm1.bias")}
    for slot, name in enumerate(("q", "k", "v")):
        out[f"{layer}.{name}.weight"] = qkv_w[slot * hidden : (slot + 1) * hidden]
        out[f"{layer}.{name}.bias"] = qkv_b[slot * hidden : (slot + 1) * hidden]
    for source, target, gamma_name in (("attn.proj", "attn_out", "gamma_1"), ("mlp.fc2", "ffn_out", "gamma_2")):
        weight, bias = state.take(f"{base}.{source}.weight"), state.take(f"{base}.{source}.bias")
        gamma = optional(f"{base}.{gamma_name}")
        if gamma is not None:
            weight, bias = weight * gamma[:, None], bias * gamma
        out[f"{layer}.{target}.weight"], out[f"{layer}.{target}.bias"] = weight, bias
    out[f"{layer}.ffn_ln.weight"] = state.take(f"{base}.norm2.weight")
    out[f"{layer}.ffn_ln.bias"] = state.take(f"{base}.norm2.bias")
    out[f"{layer}.ffn_in.weight"] = state.take(f"{base}.mlp.fc1.weight")
    out[f"{layer}.ffn_in.bias"] = state.take(f"{base}.mlp.fc1.bias")
    return out


def convert_funasr_state(raw_state: Mapping[str, torch.Tensor]) -> tuple[Wav2Vec2Config, dict[str, torch.Tensor]]:
    """A normalized FunASR state → ``(inferred config, float32 Wav2Vec2Encoder state_dict)``.

    Refuses a layout with tensors the conversion did not consume (they would
    be silently dropped), except the positional encoder's LayerNorm keys,
    which the module applies without weights (the JAX converter's rule).
    """
    config = config_from_funasr_state(raw_state)
    hidden = config.hidden_size
    state = AuditedState(raw_state)
    out: dict[str, np.ndarray] = {}
    for i in range(len(config.conv_dim)):
        out[f"feature_encoder.conv.{i}.weight"] = state.take(f"{_CONV}{i}.0.weight")
        bias = state.take(f"{_CONV}{i}.0.bias") if f"{_CONV}{i}.0.bias" in state else None
        if config.feat_extract_norm == "layer":
            out[f"feature_encoder.conv.{i}.bias"] = bias if bias is not None else np.zeros(config.conv_dim[i])
            out[f"feature_encoder.conv_ln.{i}.weight"] = state.take(f"{_CONV}{i}.2.1.weight")
            out[f"feature_encoder.conv_ln.{i}.bias"] = state.take(f"{_CONV}{i}.2.1.bias")
        elif i == 0 and f"{_CONV}0.2.weight" in state:
            out["feature_encoder.conv_gn.weight"] = state.take(f"{_CONV}0.2.weight")
            out["feature_encoder.conv_gn.bias"] = state.take(f"{_CONV}0.2.bias")

    projection = "project_features" if _AUDIO + "project_features.weight" in state else "project_features.2"
    out["feature_projection.weight"] = state.take(f"{_AUDIO}{projection}.weight")
    out["feature_projection.bias"] = state.take(f"{_AUDIO}{projection}.bias")
    if config.feature_norm_before_projection:
        out["feature_ln.weight"] = state.take(_AUDIO + "project_features.1.weight")
        out["feature_ln.bias"] = state.take(_AUDIO + "project_features.1.bias")

    # Depth > 1 builds StackedConvPositionalEmbedding (``pos_conv.{i}``),
    # depth 1 the single wav2vec2 ConvPositionalEmbedding (``pos_conv``).
    for i in range(config.conv_pos_depth):
        target = f"pos_embed.pos_conv.{i}" if config.conv_pos_depth > 1 else "pos_embed.pos_conv"
        out[f"{target}.weight"] = state.take(f"{_POS}{i}.0.weight")
        out[f"{target}.bias"] = state.take(f"{_POS}{i}.0.bias")

    bases = [f"{_PRENET}{i}" for i in range(_count_blocks(raw_state, _PRENET))]
    bases += [f"blocks.{i}" for i in range(_count_blocks(raw_state, "blocks."))]
    for layer, base in enumerate(bases):
        out.update(_block(state, base, f"layers.{layer}", hidden))

    if config.encoder_norm:
        out["encoder_final_ln.weight"] = state.take("norm.weight")
        out["encoder_final_ln.bias"] = state.take("norm.bias")

    leftovers = [key for key in state.unconsumed() if not (key.startswith(_POS) and ".0." not in key)]
    if leftovers:
        raise unconsumed_key_error(leftovers, model="emotion2vec")
    return config, {name: _tensor(array) for name, array in out.items()}


def load_funasr_emotion2vec_state(model_dir: str | Path) -> tuple[Wav2Vec2Config, dict[str, torch.Tensor]]:
    """Converts a staged FunASR emotion2vec checkpoint: ``(inferred config, state_dict)``."""
    return convert_funasr_state(load_funasr_state_dict(model_dir))


__all__ = [
    "config_from_funasr_state",
    "convert_funasr_state",
    "load_funasr_emotion2vec_state",
    "load_funasr_state_dict",
    "normalize_funasr_state",
]
