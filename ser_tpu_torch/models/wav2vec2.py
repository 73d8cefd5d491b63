"""wav2vec2 / XLS-R speech encoder in PyTorch: the medium profile's compute core.

Counterpart of ``ser_tpu/models/wav2vec2.py``: the strided conv feature
encoder (``"conv"`` through ``F.conv1d``, or ``"matmul"``: each conv as one
product over its patches), the grouped-conv positional embedding (one 128-wide
conv, or data2vec's stack of smaller ones), and the pre-norm transformer
stack, whose self-attention runs kernel K2 (bf16) or K2-f32 (float32) on the
card with the frame mask as a key mask.

The dtype policy is the JAX package's: parameters are stored in one dtype
(bf16 for a bf16 backend, ``param_utils.cast_state_bf16``), the transformer
layers' products run in ``compute_dtype``, and everything flax computes in
the promotion of a float32 input with the stored weights runs in float32:
the conv front end, its LayerNorms, the feature projection, the positional
convs, every LayerNorm (float32 statistics with flax's fast variance
E[x²]−E[x]²) and the residual stream. The output is float32. A float32
convolution on the card is kept in float32 (cuDNN would take TF32 by
default), as float32 matrix products are (PyTorch's default).

Layouts: activations are (B, T, C), as flax's; conv weights are
``nn.Conv1d``'s (out, in/groups, k) for both front ends; dense weights are
``nn.Linear``'s (out, in). ``convert.py`` carries a JAX parameter tree across,
``load_hf_wav2vec2_state`` reads a local HF checkpoint (with the port's own
safetensors reader and the JAX loader's consumed-key audit), and
``random_wav2vec2_state`` makes seeded weights at any size.
"""

from __future__ import annotations

import json
import math
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env
from ser_tpu_torch.models.attention import multi_head_attention
from ser_tpu_torch.models.checkpoint_audit import WAV2VEC2_IGNORED, AuditedState, unconsumed_key_error
from ser_tpu_torch.models.hf_checkpoint import read_hf_tensors
from ser_tpu_torch.models.whisper import LayerNorm, _dense
from ser_tpu_torch.ops.activations import gelu_erf


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (defaults = XLS-R 300M)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "layer"  # "layer" (XLS-R) or "group" (base)
    do_stable_layer_norm: bool = True  # pre-norm transformer (XLS-R)
    # data2vec-2.0 audio (emotion2vec): a stack of smaller pos-convs; depth 1
    # keeps the wav2vec2 module.
    conv_pos_depth: int = 1
    feature_norm_before_projection: bool = True
    encoder_norm: bool = True
    frontend_impl: str = "conv"  # "conv" | "matmul"

    @property
    def frame_stride_samples(self) -> int:
        return math.prod(self.conv_stride)  # 320 → 20 ms at 16 kHz

    @property
    def frame_receptive_samples(self) -> int:
        receptive = 1
        for k, s in zip(reversed(self.conv_kernel), reversed(self.conv_stride)):
            receptive = (receptive - 1) * s + k
        return receptive  # 400 → 25 ms at 16 kHz

    def frames_for_samples(self, samples: int) -> int:
        """Frames the front end makes of ``samples`` (0 below the receptive field)."""
        return max(0, (samples - self.frame_receptive_samples) // self.frame_stride_samples + 1)

    @classmethod
    def tiny(cls) -> "Wav2Vec2Config":
        """Small widths for tests, with the production conv strides (320-sample frames)."""
        return cls(
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            conv_dim=(32, 32, 32, 32, 32, 32, 32),
            conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2),
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
        )


@contextmanager
def _float32_convolutions(x: torch.Tensor):
    """Keeps a float32 cuDNN convolution in float32 (no TF32) for its duration."""
    if not (x.is_cuda and x.dtype == torch.float32 and torch.backends.cudnn.allow_tf32):
        yield
        return
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _conv1d(layer: nn.Conv1d, x: torch.Tensor, *, padding: int = 0) -> torch.Tensor:
    """flax ``nn.Conv`` (no ``dtype``) over (B, T, C): computed in x's dtype, (B, T', C) out."""
    weight = layer.weight.to(x.dtype)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    with _float32_convolutions(x):
        y = F.conv1d(x.transpose(1, 2), weight, bias, layer.stride, padding, 1, layer.groups)
    return y.transpose(1, 2)


def _patch_matmul(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``_PatchMatmulConv``: a VALID strided conv as a patch gather and one product.

    Tap-major patches (B, T', k·C_in) against the kernel as (k·C_in, C_out),
    the same reduction set as the convolution.
    """
    out_ch, in_ch, k = layer.weight.shape
    (stride,) = layer.stride
    patches = x.unfold(1, k, stride).transpose(2, 3).reshape(x.shape[0], -1, k * in_ch)
    kernel = layer.weight.to(x.dtype).permute(2, 1, 0).reshape(k * in_ch, out_ch)
    y = patches @ kernel
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def _fast_norm(x: torch.Tensor, dims: tuple[int, ...], eps: float) -> torch.Tensor:
    """flax's normalization: float32 statistics, variance E[x²]−E[x]² clamped at 0."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=dims, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return (x32 - mean) * torch.rsqrt(var + eps)


class ConvFeatureEncoder(nn.Module):
    """Strided 1-D conv stack: waveform (B, S) → latent frames (B, T, conv_dim[-1])."""

    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        self.config = config
        use_bias = config.feat_extract_norm == "layer"
        channels = (1, *config.conv_dim)
        self.conv = nn.ModuleList(
            nn.Conv1d(channels[i], dim, kernel, stride=stride, bias=use_bias)
            for i, (dim, kernel, stride) in enumerate(zip(config.conv_dim, config.conv_kernel, config.conv_stride))
        )
        if config.feat_extract_norm == "layer":
            self.conv_ln = nn.ModuleList(LayerNorm(dim, config.layer_norm_eps) for dim in config.conv_dim)
        else:
            # flax GroupNorm with one group per channel, after the first conv only.
            self.conv_gn = LayerNorm(config.conv_dim[0], config.layer_norm_eps)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        x = waveform[:, :, None].to(torch.float32)
        for i, layer in enumerate(self.conv):
            x = _patch_matmul(layer, x) if self.config.frontend_impl == "matmul" else _conv1d(layer, x)
            if self.config.feat_extract_norm == "layer":
                x = self.conv_ln[i](x)
            elif i == 0:
                gn = self.conv_gn
                x = (_fast_norm(x, (1,), gn.eps) * gn.weight.float() + gn.bias.float()).to(x.dtype)
            x = gelu_erf(x)
        return x


class ConvPositionalEmbedding(nn.Module):
    """Grouped-conv positional embedding (wav2vec2): hidden + GELU(conv(hidden))."""

    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, groups=config.num_conv_pos_embedding_groups
        )

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        k = self.pos_conv.kernel_size[0]
        pos = _conv1d(self.pos_conv, hidden, padding=k // 2)
        if k % 2 == 0:
            pos = pos[:, :-1, :]
        return hidden + gelu_erf(pos)


class StackedConvPositionalEmbedding(nn.Module):
    """data2vec-2.0 positional encoder: ``conv_pos_depth`` blocks of conv → non-affine LN → GELU, then add."""

    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        k = max(3, config.num_conv_pos_embeddings // config.conv_pos_depth)
        self.eps = config.layer_norm_eps
        self.pos_conv = nn.ModuleList(
            nn.Conv1d(config.hidden_size, config.hidden_size, k, groups=config.num_conv_pos_embedding_groups)
            for _ in range(config.conv_pos_depth)
        )

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        pos = hidden
        for conv in self.pos_conv:
            k = conv.kernel_size[0]
            pos = _conv1d(conv, pos, padding=k // 2)
            if k % 2 == 0:
                pos = pos[:, :-1, :]
            pos = gelu_erf(_fast_norm(pos, (-1,), self.eps).to(pos.dtype))
        return hidden + pos


class TransformerLayer(nn.Module):
    """Pre-norm (stable-LN) transformer layer; products in ``compute_dtype``, residual in float32."""

    def __init__(self, config: Wav2Vec2Config, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d = config.hidden_size
        self.heads = config.num_attention_heads
        self.compute_dtype = compute_dtype
        self.attn_ln = LayerNorm(d, config.layer_norm_eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.ffn_ln = LayerNorm(d, config.layer_norm_eps)
        self.ffn_in = nn.Linear(d, config.intermediate_size)
        self.ffn_out = nn.Linear(config.intermediate_size, d)

    def forward(self, hidden: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        batch, seq, d = hidden.shape
        dtype = self.compute_dtype
        x = self.attn_ln(hidden).to(dtype)  # once for the three projections
        heads = (batch, seq, self.heads, d // self.heads)
        q = _dense(self.q, x, dtype).view(heads)
        k = _dense(self.k, x, dtype).view(heads)
        v = _dense(self.v, x, dtype).view(heads)
        attended = multi_head_attention(q, k, v, frame_mask=frame_mask, compute_dtype=dtype)
        hidden = hidden + _dense(self.attn_out, attended.reshape(batch, seq, d), dtype).to(hidden.dtype)
        x = gelu_erf(_dense(self.ffn_in, self.ffn_ln(hidden), dtype))
        return hidden + _dense(self.ffn_out, x, dtype).to(hidden.dtype)


class Wav2Vec2Encoder(nn.Module):
    """Conv front end → projection → positional conv → transformer stack. (B, S) → (B, T, d) float32."""

    def __init__(self, config: Wav2Vec2Config, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.feature_encoder = ConvFeatureEncoder(config)
        if config.feature_norm_before_projection:
            self.feature_ln = LayerNorm(config.conv_dim[-1], config.layer_norm_eps)
        self.feature_projection = nn.Linear(config.conv_dim[-1], config.hidden_size)
        if config.conv_pos_depth > 1:
            self.pos_embed: nn.Module = StackedConvPositionalEmbedding(config)
        else:
            self.pos_embed = ConvPositionalEmbedding(config)
        if config.encoder_norm:
            final = LayerNorm(config.hidden_size, config.layer_norm_eps)
            if config.do_stable_layer_norm:
                self.encoder_final_ln = final
            else:
                self.encoder_pre_ln = final
        self.layers = nn.ModuleList(
            TransformerLayer(config, compute_dtype) for _ in range(config.num_hidden_layers)
        )

    def forward(self, waveform: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, S) samples → (B, T, hidden) float32.

        ``frame_mask`` (B, T) bool marks valid frames: padded frames are zeroed
        after the projection and excluded from attention's keys, so
        fixed-shape batching of variable-length chunks stays exact on the
        valid frames.
        """
        cfg = self.config
        latents = self.feature_encoder(waveform)
        if cfg.feature_norm_before_projection:
            latents = self.feature_ln(latents)
        hidden = _dense(self.feature_projection, latents, latents.dtype)
        if frame_mask is not None:
            hidden = hidden * frame_mask[:, :, None].to(hidden.dtype)
        hidden = self.pos_embed(hidden)
        if cfg.encoder_norm and not cfg.do_stable_layer_norm:
            hidden = self.encoder_pre_ln(hidden)
        for layer in self.layers:
            hidden = layer(hidden, frame_mask)
        if cfg.encoder_norm and cfg.do_stable_layer_norm:
            hidden = self.encoder_final_ln(hidden)
        return hidden.to(torch.float32)


def build_wav2vec2_encoder(
    config: Wav2Vec2Config,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device | str,
    compute_dtype: torch.dtype = torch.float32,
) -> Wav2Vec2Encoder:
    """An eval-mode encoder holding ``state_dict`` on ``device``, computing in ``compute_dtype``.

    The tensors keep their dtype (``cast_state_bf16`` makes a bf16 backend's
    state).

    Built on the meta device and filled by assignment, so the full-size model
    never runs PyTorch's default init or holds a second copy.
    """
    with torch.device("meta"):
        encoder = Wav2Vec2Encoder(config, compute_dtype=compute_dtype)
    placed = {name: tensor.to(device=device) for name, tensor in state_dict.items()}
    encoder.load_state_dict(placed, strict=True, assign=True)
    return encoder.eval()


def random_wav2vec2_state(
    config: Wav2Vec2Config, *, seed: int, device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """Seeded float32 weights: normal of std 1/√fan_in for conv and dense weights, zero biases, unit LayerNorms.

    The port's own ``torch.Generator`` draws them (``jax.random`` bits cannot
    be reproduced), so the parity tests carry the JAX package's weights across
    with ``convert.py`` instead. The generator lives on ``device``, so the
    values depend on the device the draw runs on: a CPU draw and a card draw
    of one seed differ. ``device`` None is the device ``SER_TORCH_DEVICE``
    names (the card, the CPU only when asked for; with neither, it raises).
    """
    device = honor_platform_env() if device is None else torch.device(device)
    with torch.device("meta"):
        shapes = {name: tensor.shape for name, tensor in Wav2Vec2Encoder(config).state_dict().items()}
    generator = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            state[name] = torch.zeros(shape, device=device)
        elif len(shape) == 1:
            state[name] = torch.ones(shape, device=device)
        else:
            fan_in = math.prod(shape[1:])
            state[name] = torch.randn(shape, generator=generator, device=device) / math.sqrt(fan_in)
    return state


# --------------------------------------------------------------------------- #
# HF checkpoint conversion
# --------------------------------------------------------------------------- #


def config_from_hf_dir(model_dir) -> Wav2Vec2Config:
    """A config from a local HF ``config.json``."""
    raw = json.loads((Path(model_dir) / "config.json").read_text(encoding="utf-8"))
    return Wav2Vec2Config(
        hidden_size=raw["hidden_size"],
        num_hidden_layers=raw["num_hidden_layers"],
        num_attention_heads=raw["num_attention_heads"],
        intermediate_size=raw["intermediate_size"],
        conv_dim=tuple(raw["conv_dim"]),
        conv_kernel=tuple(raw["conv_kernel"]),
        conv_stride=tuple(raw["conv_stride"]),
        num_conv_pos_embeddings=raw["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=raw["num_conv_pos_embedding_groups"],
        layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
        feat_extract_norm=raw.get("feat_extract_norm", "layer"),
        do_stable_layer_norm=raw.get("do_stable_layer_norm", True),
    )


def _hf_params(model_dir, config: Wav2Vec2Config) -> dict:
    """The checkpoint as ``ser_tpu.models.wav2vec2.load_hf_wav2vec2_params``'s tree of numpy arrays."""
    sd = AuditedState(read_hf_tensors(model_dir))

    def t(name):  # with the wav2vec2. prefix of task-model exports
        for key in (name, f"wav2vec2.{name}"):
            if key in sd:
                return sd.take(key)
        raise KeyError(f"Missing weight {name!r} in checkpoint.")

    def ln(base):
        return {"scale": t(f"{base}.weight"), "bias": t(f"{base}.bias")}

    def dense(base):
        return {"kernel": t(f"{base}.weight").T, "bias": t(f"{base}.bias")}

    params: dict = {"feature_encoder": {}, "pos_embed": {}}
    fe = params["feature_encoder"]
    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": t(f"{base}.conv.weight").transpose(2, 1, 0)}
        if config.feat_extract_norm == "layer":
            conv["bias"] = t(f"{base}.conv.bias")
            fe[f"conv_ln_{i}"] = ln(f"{base}.layer_norm")
        elif i == 0:
            fe["conv_gn"] = ln(f"{base}.layer_norm")
        fe[f"conv_{i}"] = conv
    params["feature_ln"] = ln("feature_projection.layer_norm")
    params["feature_projection"] = dense("feature_projection.projection")

    # HF stores the pos-conv kernel weight-normalized (weight = g·v/‖v‖) in one
    # of three layouts: plain ``weight``, ``weight_g``/``weight_v``, or torch
    # >= 2.1's ``parametrizations.weight.original0/1``.
    base = "encoder.pos_conv_embed.conv"
    try:
        weight = t(f"{base}.weight")
    except KeyError:
        try:
            g, v = t(f"{base}.weight_g"), t(f"{base}.weight_v")
        except KeyError:
            g = t(f"{base}.parametrizations.weight.original0")
            v = t(f"{base}.parametrizations.weight.original1")
        weight = g * v / np.maximum(np.linalg.norm(v, axis=(0, 1), keepdims=True), 1e-12)
    params["pos_embed"]["pos_conv"] = {"kernel": weight.transpose(2, 1, 0), "bias": t(f"{base}.bias")}
    params["encoder_final_ln" if config.do_stable_layer_norm else "encoder_pre_ln"] = ln("encoder.layer_norm")

    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "attn_ln": ln(f"{base}.layer_norm"),
            "q": dense(f"{base}.attention.q_proj"),
            "k": dense(f"{base}.attention.k_proj"),
            "v": dense(f"{base}.attention.v_proj"),
            "attn_out": dense(f"{base}.attention.out_proj"),
            "ffn_ln": ln(f"{base}.final_layer_norm"),
            "ffn_in": dense(f"{base}.feed_forward.intermediate_dense"),
            "ffn_out": dense(f"{base}.feed_forward.output_dense"),
        }

    variants = [(entry, f"wav2vec2.{entry}") for entry in WAV2VEC2_IGNORED]
    leftovers = sd.unconsumed(
        ignore_exact=tuple(name for pair in variants for name in pair if not name.endswith(".")),
        ignore_prefixes=tuple(name for pair in variants for name in pair if name.endswith(".")),
    )
    if leftovers:
        raise unconsumed_key_error(leftovers, model="wav2vec2")
    return params


def load_hf_wav2vec2_state(model_dir, config: Wav2Vec2Config) -> dict[str, torch.Tensor]:
    """A local HF wav2vec2 checkpoint as this module's float32 ``state_dict``.

    The conversion of ``ser_tpu.models.wav2vec2.load_hf_wav2vec2_params``:
    missing weights raise by name, and a tensor the conversion never consumed
    (an adapter stack, an unexpected norm, a renamed layout) refuses the load,
    except the pretraining and task heads of ``WAV2VEC2_IGNORED``.
    """
    from ser_tpu_torch.models.convert import wav2vec2_state_dict

    return wav2vec2_state_dict(_hf_params(model_dir, config))


__all__ = [
    "ConvFeatureEncoder",
    "ConvPositionalEmbedding",
    "StackedConvPositionalEmbedding",
    "TransformerLayer",
    "Wav2Vec2Config",
    "Wav2Vec2Encoder",
    "build_wav2vec2_encoder",
    "config_from_hf_dir",
    "load_hf_wav2vec2_state",
    "random_wav2vec2_state",
]
