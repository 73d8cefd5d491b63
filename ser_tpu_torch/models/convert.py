"""Carries JAX parameters across into the PyTorch port.

- ``whisper_encoder_state_dict``: the flax parameter tree of
  ``ser_tpu.models.whisper.WhisperEncoder`` (nested dicts of numpy arrays, from
  ``init_whisper_encoder_params`` or ``load_hf_whisper_encoder_params``) →
  the ``state_dict`` of ``ser_tpu_torch.models.whisper.WhisperEncoder``.
  flax Conv kernels (k, in, out) become (out, in, k); Dense kernels (in, out)
  become (out, in); LayerNorm ``scale`` becomes ``weight``.
- ``whisper_decoder_state_dict``: the flax tree of ``ser_tpu.models.whisper.
  WhisperDecoder`` (``decoder.init`` or ``load_hf_whisper_decoder_params``) →
  the ``state_dict`` of ``ser_tpu_torch.models.whisper.WhisperDecoder``, with
  the same layout rules; ``tok_embed`` and ``pos_embed`` carry over as they
  are, and the bias-free ``k`` projections stay bias-free.
- ``wav2vec2_state_dict``: the flax tree of ``ser_tpu.models.wav2vec2.
  Wav2Vec2Encoder`` (``init_wav2vec2_params`` or ``load_hf_wav2vec2_params``)
  → the ``state_dict`` of ``ser_tpu_torch.models.wav2vec2.Wav2Vec2Encoder``,
  and ``flax_wav2vec2_params`` its inverse. The front end's ``conv_{i}``,
  ``conv_ln_{i}`` become ``conv.{i}``, ``conv_ln.{i}``, a stacked positional
  encoder's ``pos_conv_{i}`` becomes ``pos_conv.{i}``, and ``layer_{i}``
  becomes ``layers.{i}``; both front ends share the conv layout.
- ``mlp_head_layers``: a ``ser_tpu_mlp`` head state (``JaxMLPClassifier.
  get_state()``) → the head's (weight (in, out), bias) float32 pairs, as
  ``ser_tpu_torch.models.mlp_head.TorchMLPClassifier.from_state`` reads them.

- ``train_head_params``: the training step's head dict ``{w1, b1, w2, b2}``
  (flax layout, ``w`` (in, out)) → float32 tensors of the same layout, as
  ``ser_tpu_torch.parallel.train_step`` takes it.
- ``flax_whisper_encoder_params`` and ``flax_head_params``: the inverses,
  port → flax layout as numpy float32, so that trained parameters and
  gradients can be held against the JAX package's leaf by leaf.
- ``separator_state_dict``: the flax tree of ``ser_tpu.models.separation.
  SpecUNetSeparator`` (``init_separator_params`` or ``load_separator_params``
  of either package) → the ``state_dict`` of ``ser_tpu_torch.models.
  separation.SpecUNetSeparator``, and ``flax_separator_params`` its inverse.
  Conv kernels (kt, kf, in, out) become (out, in, kt, kf); the decoder's
  transposed-conv kernels become (in, out, kt, kf) flipped on both spatial
  axes (flax applies them unflipped, ``F.conv_transpose2d`` flipped);
  attention's (D, H, hd) and (H, hd, D) kernels become (D, D) ``Linear``
  weights; GroupNorm and LayerNorm ``scale`` becomes ``weight``.
- ``demucs_params``: the htdemucs tree (``demucs_v4.convert_demucs_state_dict``
  or ``load_demucs_npz`` of either package) as tensors on one device; it
  keeps the published torch layouts, so nothing is transposed.

Values are float32; the caller places and casts them (``build_whisper_encoder``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True))


def _dense(prefix: str, params: Mapping) -> dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _tensor(np.asarray(params["kernel"]).T)}
    if "bias" in params:
        out[f"{prefix}.bias"] = _tensor(params["bias"])
    return out


def _conv(prefix: str, params: Mapping) -> dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _tensor(np.asarray(params["kernel"]).transpose(2, 1, 0)),
        f"{prefix}.bias": _tensor(params["bias"]),
    }


def _layer_norm(prefix: str, params: Mapping) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _tensor(params["scale"]), f"{prefix}.bias": _tensor(params["bias"])}


def whisper_encoder_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax Whisper-encoder tree → port ``state_dict`` (float32 CPU tensors)."""
    state = {
        **_conv("conv1", params["conv1"]),
        **_conv("conv2", params["conv2"]),
        **_layer_norm("final_ln", params["final_ln"]),
    }
    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for i in range(n_layers):
        layer = params[f"layer_{i}"]
        base = f"layers.{i}"
        state.update(_layer_norm(f"{base}.attn_ln", layer["attn_ln"]))
        for name in ("q", "k", "v", "out"):
            state.update(_dense(f"{base}.attn.{name}", layer["attn"][name]))
        state.update(_layer_norm(f"{base}.mlp_ln", layer["mlp_ln"]))
        state.update(_dense(f"{base}.mlp_in", layer["mlp_in"]))
        state.update(_dense(f"{base}.mlp_out", layer["mlp_out"]))
    return state


def whisper_decoder_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax Whisper-decoder tree → port ``state_dict`` (float32 CPU tensors)."""
    state = {
        "tok_embed": _tensor(params["tok_embed"]),
        "pos_embed": _tensor(params["pos_embed"]),
        **_layer_norm("final_ln", params["final_ln"]),
    }
    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for i in range(n_layers):
        layer = params[f"layer_{i}"]
        base = f"layers.{i}"
        for block in ("attn", "cross"):
            state.update(_layer_norm(f"{base}.{block}_ln", layer[f"{block}_ln"]))
            for name in ("q", "k", "v", "out"):
                state.update(_dense(f"{base}.{block}.{name}", layer[block][name]))
        state.update(_layer_norm(f"{base}.mlp_ln", layer["mlp_ln"]))
        state.update(_dense(f"{base}.mlp_in", layer["mlp_in"]))
        state.update(_dense(f"{base}.mlp_out", layer["mlp_out"]))
    return state


def wav2vec2_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax wav2vec2-encoder tree → port ``state_dict`` (float32 CPU tensors)."""
    fe = params["feature_encoder"]
    state: dict[str, torch.Tensor] = {}
    n_convs = sum(1 for key in fe if key.startswith("conv_") and key[5:].isdigit())
    for i in range(n_convs):
        conv = fe[f"conv_{i}"]
        state[f"feature_encoder.conv.{i}.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(2, 1, 0))
        if "bias" in conv:
            state[f"feature_encoder.conv.{i}.bias"] = _tensor(conv["bias"])
        if f"conv_ln_{i}" in fe:
            state.update(_layer_norm(f"feature_encoder.conv_ln.{i}", fe[f"conv_ln_{i}"]))
    if "conv_gn" in fe:
        state.update(_layer_norm("feature_encoder.conv_gn", fe["conv_gn"]))
    if "feature_ln" in params:
        state.update(_layer_norm("feature_ln", params["feature_ln"]))
    state.update(_dense("feature_projection", params["feature_projection"]))
    pos = params["pos_embed"]
    if "pos_conv" in pos:
        state.update(_conv("pos_embed.pos_conv", pos["pos_conv"]))
    for i in range(sum(1 for key in pos if key.startswith("pos_conv_"))):
        state.update(_conv(f"pos_embed.pos_conv.{i}", pos[f"pos_conv_{i}"]))
    for name in ("encoder_pre_ln", "encoder_final_ln"):
        if name in params:
            state.update(_layer_norm(name, params[name]))
    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for i in range(n_layers):
        layer = params[f"layer_{i}"]
        for name in ("attn_ln", "ffn_ln"):
            state.update(_layer_norm(f"layers.{i}.{name}", layer[name]))
        for name in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out"):
            state.update(_dense(f"layers.{i}.{name}", layer[name]))
    return state


def mlp_head_layers(state: Mapping) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``ser_tpu_mlp`` head state → [(weight (in, out), bias (out,))] float32."""
    if state.get("kind") != "ser_tpu_mlp":
        raise ValueError("Not a ser_tpu_mlp state payload.")
    return [(_tensor(w), _tensor(b)) for w, b in zip(state["weights"], state["biases"])]


def train_head_params(head: Mapping) -> dict[str, torch.Tensor]:
    """Training head ``{w1, b1, w2, b2}`` (flax layout) → float32 tensors, same layout."""
    return {name: _tensor(head[name]) for name in ("w1", "b1", "w2", "b2")}


def _array(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().to(device="cpu", dtype=torch.float32).numpy()


def flax_whisper_encoder_params(state: Mapping[str, torch.Tensor]) -> dict:
    """Port encoder ``state_dict`` (or its gradients by the same names) → flax tree of numpy float32."""

    def dense(prefix: str) -> dict:
        out = {"kernel": np.ascontiguousarray(_array(state[f"{prefix}.weight"]).T)}
        if f"{prefix}.bias" in state:
            out["bias"] = _array(state[f"{prefix}.bias"])
        return out

    def conv(prefix: str) -> dict:
        kernel = np.ascontiguousarray(_array(state[f"{prefix}.weight"]).transpose(2, 1, 0))
        return {"kernel": kernel, "bias": _array(state[f"{prefix}.bias"])}

    def layer_norm(prefix: str) -> dict:
        return {"scale": _array(state[f"{prefix}.weight"]), "bias": _array(state[f"{prefix}.bias"])}

    params = {"conv1": conv("conv1"), "conv2": conv("conv2"), "final_ln": layer_norm("final_ln")}
    n_layers = sum(1 for key in state if key.startswith("layers.") and key.endswith(".attn_ln.weight"))
    for i in range(n_layers):
        base = f"layers.{i}"
        params[f"layer_{i}"] = {
            "attn_ln": layer_norm(f"{base}.attn_ln"),
            "attn": {name: dense(f"{base}.attn.{name}") for name in ("q", "k", "v", "out")},
            "mlp_ln": layer_norm(f"{base}.mlp_ln"),
            "mlp_in": dense(f"{base}.mlp_in"),
            "mlp_out": dense(f"{base}.mlp_out"),
        }
    return params


def flax_wav2vec2_params(state: Mapping[str, torch.Tensor]) -> dict:
    """Port wav2vec2 ``state_dict`` → flax tree of numpy float32 (the inverse of ``wav2vec2_state_dict``)."""

    def kernel(prefix: str) -> np.ndarray:
        return np.ascontiguousarray(_array(state[f"{prefix}.weight"]).transpose(2, 1, 0))

    def dense(prefix: str) -> dict:
        return {"kernel": np.ascontiguousarray(_array(state[f"{prefix}.weight"]).T), "bias": _array(state[f"{prefix}.bias"])}

    def layer_norm(prefix: str) -> dict:
        return {"scale": _array(state[f"{prefix}.weight"]), "bias": _array(state[f"{prefix}.bias"])}

    fe: dict = {}
    i = 0
    while f"feature_encoder.conv.{i}.weight" in state:
        base = f"feature_encoder.conv.{i}"
        fe[f"conv_{i}"] = {"kernel": kernel(base)}
        if f"{base}.bias" in state:
            fe[f"conv_{i}"]["bias"] = _array(state[f"{base}.bias"])
        if f"feature_encoder.conv_ln.{i}.weight" in state:
            fe[f"conv_ln_{i}"] = layer_norm(f"feature_encoder.conv_ln.{i}")
        i += 1
    if "feature_encoder.conv_gn.weight" in state:
        fe["conv_gn"] = layer_norm("feature_encoder.conv_gn")
    params: dict = {"feature_encoder": fe, "feature_projection": dense("feature_projection"), "pos_embed": {}}
    if "feature_ln.weight" in state:
        params["feature_ln"] = layer_norm("feature_ln")
    if "pos_embed.pos_conv.weight" in state:
        params["pos_embed"]["pos_conv"] = {"kernel": kernel("pos_embed.pos_conv"),
                                           "bias": _array(state["pos_embed.pos_conv.bias"])}
    i = 0
    while f"pos_embed.pos_conv.{i}.weight" in state:
        params["pos_embed"][f"pos_conv_{i}"] = {"kernel": kernel(f"pos_embed.pos_conv.{i}"),
                                                "bias": _array(state[f"pos_embed.pos_conv.{i}.bias"])}
        i += 1
    for name in ("encoder_pre_ln", "encoder_final_ln"):
        if f"{name}.weight" in state:
            params[name] = layer_norm(name)
    i = 0
    while f"layers.{i}.attn_ln.weight" in state:
        base = f"layers.{i}"
        params[f"layer_{i}"] = {
            **{name: layer_norm(f"{base}.{name}") for name in ("attn_ln", "ffn_ln")},
            **{name: dense(f"{base}.{name}") for name in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")},
        }
        i += 1
    return params


def flax_head_params(head: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Training head tensors (or their gradients) → flax dict of numpy float32."""
    return {name: _array(head[name]) for name in ("w1", "b1", "w2", "b2")}


def separator_state_dict(params: Mapping, config) -> dict[str, torch.Tensor]:
    """flax U-Net separator tree → port ``SpecUNetSeparator`` ``state_dict`` (float32 CPU tensors)."""
    state: dict[str, torch.Tensor] = {}

    def conv(prefix: str, leaf: Mapping) -> None:
        state[f"{prefix}.weight"] = _tensor(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        state[f"{prefix}.bias"] = _tensor(leaf["bias"])

    def norm(prefix: str, leaf: Mapping) -> None:
        state.update(_layer_norm(prefix, leaf))

    for index in range(len(config.channels)):
        conv(f"enc.{index}.conv", params[f"enc{index}"]["conv"])
        norm(f"enc.{index}.norm", params[f"enc{index}"]["norm"])
        dec = params[f"dec{index}"]
        # (kt, kf, in, out), applied unflipped → (in, out, kt, kf), flipped for F.conv_transpose2d.
        kernel = np.asarray(dec["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        state[f"dec.{index}.weight"] = _tensor(kernel)
        state[f"dec.{index}.bias"] = _tensor(dec["bias"])
        if index > 0:
            norm(f"dec_norm.{index}", params[f"dec{index}_norm"])
    state.update(_dense("bottleneck_in", params["bottleneck_in"]))
    state.update(_dense("bottleneck_out", params["bottleneck_out"]))
    for index in range(config.bottleneck_layers):
        layer, base = params[f"bottleneck{index}"], f"bottleneck.{index}"
        norm(f"{base}.attn_norm", layer["attn_norm"])
        norm(f"{base}.ffn_norm", layer["ffn_norm"])
        state.update(_dense(f"{base}.ffn_up", layer["ffn_up"]))
        state.update(_dense(f"{base}.ffn_down", layer["ffn_down"]))
        for name in ("query", "key", "value"):
            kernel = np.asarray(layer["attn"][name]["kernel"])
            state[f"{base}.attn.{name}.weight"] = _tensor(kernel.reshape(kernel.shape[0], -1).T)
            state[f"{base}.attn.{name}.bias"] = _tensor(np.asarray(layer["attn"][name]["bias"]).reshape(-1))
        kernel = np.asarray(layer["attn"]["out"]["kernel"])
        state[f"{base}.attn.out.weight"] = _tensor(kernel.reshape(-1, kernel.shape[-1]).T)
        state[f"{base}.attn.out.bias"] = _tensor(layer["attn"]["out"]["bias"])
    return state


def flax_separator_params(state: Mapping[str, torch.Tensor], config) -> dict:
    """Port ``SpecUNetSeparator`` ``state_dict`` (or its gradients) → flax tree of numpy float32."""

    def dense(prefix: str) -> dict:
        return {"kernel": np.ascontiguousarray(_array(state[f"{prefix}.weight"]).T), "bias": _array(state[f"{prefix}.bias"])}

    def norm(prefix: str) -> dict:
        return {"scale": _array(state[f"{prefix}.weight"]), "bias": _array(state[f"{prefix}.bias"])}

    params: dict = {"bottleneck_in": dense("bottleneck_in"), "bottleneck_out": dense("bottleneck_out")}
    for index in range(len(config.channels)):
        conv = _array(state[f"enc.{index}.conv.weight"]).transpose(2, 3, 1, 0)
        params[f"enc{index}"] = {
            "conv": {"kernel": np.ascontiguousarray(conv), "bias": _array(state[f"enc.{index}.conv.bias"])},
            "norm": norm(f"enc.{index}.norm"),
        }
        kernel = _array(state[f"dec.{index}.weight"])[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        params[f"dec{index}"] = {"kernel": np.ascontiguousarray(kernel), "bias": _array(state[f"dec.{index}.bias"])}
        if index > 0:
            params[f"dec{index}_norm"] = norm(f"dec_norm.{index}")
    dim = config.channels[-1]
    heads = config.bottleneck_heads
    for index in range(config.bottleneck_layers):
        base = f"bottleneck.{index}"
        attn = {}
        for name in ("query", "key", "value"):
            weight = _array(state[f"{base}.attn.{name}.weight"])
            attn[name] = {"kernel": np.ascontiguousarray(weight.T.reshape(dim, heads, dim // heads)),
                          "bias": _array(state[f"{base}.attn.{name}.bias"]).reshape(heads, dim // heads)}
        attn["out"] = {"kernel": np.ascontiguousarray(_array(state[f"{base}.attn.out.weight"]).T.reshape(heads, dim // heads, dim)),
                       "bias": _array(state[f"{base}.attn.out.bias"])}
        params[f"bottleneck{index}"] = {
            "attn_norm": norm(f"{base}.attn_norm"),
            "attn": attn,
            "ffn_norm": norm(f"{base}.ffn_norm"),
            "ffn_up": dense(f"{base}.ffn_up"),
            "ffn_down": dense(f"{base}.ffn_down"),
        }
    return params


def demucs_params(tree, *, device: torch.device | str | None = None, dtype: torch.dtype = torch.float32):
    """The htdemucs tree as ``dtype`` tensors on ``device`` (no copy for leaves already there).

    ``device`` None keeps tensor leaves where they are and places numpy
    leaves on the device ``SER_TORCH_DEVICE`` names (the card unless the CPU
    is asked for).
    """
    if device is None:
        leaf = tree["freq_emb"]["weight"]
        if isinstance(leaf, torch.Tensor):
            device = leaf.device
        else:
            import os

            from ser_tpu_torch._internal.repr.runtime_policy import resolve_device

            device = resolve_device(os.environ.get("SER_TORCH_DEVICE", "auto"))

    def place(node):
        if isinstance(node, dict):
            return {key: place(value) for key, value in node.items()}
        if isinstance(node, list):
            return [place(value) for value in node]
        return torch.as_tensor(np.asarray(node) if not isinstance(node, torch.Tensor) else node).to(device, dtype)

    return place(tree)


__all__ = [
    "demucs_params",
    "flax_head_params",
    "flax_separator_params",
    "flax_wav2vec2_params",
    "flax_whisper_encoder_params",
    "mlp_head_layers",
    "separator_state_dict",
    "train_head_params",
    "wav2vec2_state_dict",
    "whisper_decoder_state_dict",
    "whisper_encoder_state_dict",
]
