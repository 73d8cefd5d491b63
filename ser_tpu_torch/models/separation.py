"""Demucs-class spectrogram U-Net vocal separator in PyTorch (the in-house checkpoint lane).

Counterpart of ``ser_tpu/models/separation.py`` (a flax module there): a
spectrogram U-Net (strided GLU convolutions down the frequency axis, a small
pre-norm transformer over time, a mirrored transposed-conv decoder with
skips) that masks the mixture's complex STFT with a soft vocal mask in
[0, 1]. Masking keeps the phase, so the worst case degenerates to the mixture.

``SpecUNetSeparator`` is an ``nn.Module`` that computes what the flax module
computes, block for block: ``_GLUConv`` pads the frequency axis
asymmetrically ``(k//2 - 1, k//2)`` before an unpadded convolution and splits
``gate, value`` (htdemucs's GLU splits ``value, gate``); GroupNorm(4) and
LayerNorm use flax's epsilon 1e-6; the attention is flax's
``MultiHeadDotProductAttention`` (query scaled before the product); the
decoder's transposed convolutions follow ``lax.conv_transpose`` with
``padding="SAME"`` and an unflipped kernel (``_same_transpose``). Parameters
travel as the flax tree (``.npz``, the JAX package's keys and config record);
``models/convert.py`` maps that tree to this module's ``state_dict`` and back.

``init_separator_params`` cannot reproduce ``jax.random``: it draws flax's
initializers' distributions (truncated LeCun normal kernels, zero biases,
unit norm scales) from a seeded numpy generator and returns the flax-layout
tree, so its ``.npz`` loads in ``ser_tpu`` (``ROADMAP.md``, Queue 3).
``separate_vocals_neural`` runs all of a file's segments in one call, without
the JAX package's power-of-two row padding (every normalization is per row).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.models.demucs_v4 import strict_float32
from ser_tpu_torch.ops.activations import gelu_erf as _gelu

_EPS = 1e-8
#: flax's GroupNorm and LayerNorm epsilon.
_NORM_EPS = 1e-6


@dataclass(frozen=True)
class SeparatorConfig:
    """Architecture + inference hyperparameters."""

    n_fft: int = 1024
    hop: int = 256
    #: Encoder channel ladder; depth = len(channels). The frequency axis is
    #: divided by ``freq_stride`` per layer (512 → 2 at the default depth).
    channels: tuple[int, ...] = (32, 64, 128, 256)
    freq_kernel: int = 8
    freq_stride: int = 4
    time_kernel: int = 3
    bottleneck_layers: int = 2
    bottleneck_heads: int = 8
    sample_rate: int = 16000
    segment_seconds: float = 10.0
    overlap: float = 0.25

    @property
    def freq_bins(self) -> int:
        # The Nyquist bin is dropped so the frequency axis stays a power of
        # two through the stride ladder (the hybrid-demucs convention).
        return self.n_fft // 2

    @property
    def segment_samples(self) -> int:
        return int(self.segment_seconds * self.sample_rate)

    @property
    def bottom_freq(self) -> int:
        """Frequency rows left after the encoder's strides."""
        freq, padding = self.freq_bins, 2 * (self.freq_kernel // 2) - 1
        for _ in self.channels:
            freq = (freq + padding - self.freq_kernel) // self.freq_stride + 1
        return freq

    @classmethod
    def tiny(cls) -> "SeparatorConfig":
        """Small config for tests: fast init, sub-second apply on CPU."""
        return cls(n_fft=256, hop=64, channels=(8, 16), bottleneck_layers=1, bottleneck_heads=2, segment_seconds=1.0)


class _GLUConv(nn.Module):
    """Conv2D (time × freq) with GroupNorm and GLU gating: the encoder block. (B, C, T, F)."""

    def __init__(self, in_features: int, features: int, cfg: SeparatorConfig) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_features, 2 * features, (cfg.time_kernel, cfg.freq_kernel), stride=(1, cfg.freq_stride))
        self.norm = nn.GroupNorm(4, 2 * features, eps=_NORM_EPS)
        # flax's explicit padding: time (k//2, k//2), frequency (k//2 - 1, k//2).
        self._padding = (cfg.freq_kernel // 2 - 1, cfg.freq_kernel // 2, cfg.time_kernel // 2, cfg.time_kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, value = self.norm(self.conv(F.pad(x, self._padding))).chunk(2, dim=1)
        return value * torch.sigmoid(gate)


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask): (B, T, D)."""

    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        head_dim = d // self.heads

        def split(y: torch.Tensor) -> torch.Tensor:
            return y.reshape(b, t, self.heads, head_dim).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(head_dim)
        weights = torch.softmax(torch.matmul(q, split(self.key(x)).transpose(-1, -2)), dim=-1)
        out = torch.matmul(weights, split(self.value(x)))
        return self.out(out.transpose(1, 2).reshape(b, t, d))


class _BottleneckLayer(nn.Module):
    """Pre-norm transformer layer over the time axis: (B, T, D)."""

    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=_NORM_EPS)
        self.attn = _Attention(dim, heads)
        self.ffn_norm = nn.LayerNorm(dim, eps=_NORM_EPS)
        self.ffn_up = nn.Linear(dim, 4 * dim)
        self.ffn_down = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x))
        return x + self.ffn_down(_gelu(self.ffn_up(self.ffn_norm(x))))


def _same_transpose_padding(kernel: int, stride: int) -> tuple[int, int]:
    """``lax.conv_transpose``'s (before, after) padding of the dilated input for ``"SAME"``."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else math.ceil(total / 2)
    return before, total - before


def _same_transpose(layer: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.ConvTranspose(padding="SAME")`` with its kernel unflipped, over (B, C, T, F).

    ``lax.conv_transpose`` correlates the stride-dilated input, padded
    (before, after), with the kernel as it is; ``F.conv_transpose2d`` is that
    correlation with the kernel flipped and padded ``k - 1`` on both sides,
    so ``layer.weight`` holds the flax kernel flipped (``models/convert.py``),
    and the full output is cropped or zero-extended to lax's window.
    """
    y = F.conv_transpose2d(x, layer.weight, None, stride=layer.stride)
    crop = []
    for axis in (3, 2):  # F.pad order: last axis first
        kernel, stride = layer.kernel_size[axis - 2], layer.stride[axis - 2]
        before, after = _same_transpose_padding(kernel, stride)
        offset = kernel - 1 - before
        length = (x.shape[axis] - 1) * stride + before + after - kernel + 2
        crop += [-offset, length - (y.shape[axis] - offset)]
    return F.pad(y, crop) + layer.bias[None, :, None, None]


class SpecUNetSeparator(nn.Module):
    """Spectrogram-masking U-Net: mixture magnitude (B, T, F) → vocal mask in [0, 1]."""

    def __init__(self, config: SeparatorConfig) -> None:
        super().__init__()
        cfg = self.config = config
        ins = (1, *cfg.channels[:-1])
        self.enc = nn.ModuleList(_GLUConv(i, o, cfg) for i, o in zip(ins, cfg.channels))
        dim = cfg.channels[-1]
        flat = cfg.bottom_freq * dim
        self.bottleneck_in = nn.Linear(flat, dim)
        self.bottleneck = nn.ModuleList(_BottleneckLayer(dim, cfg.bottleneck_heads) for _ in range(cfg.bottleneck_layers))
        self.bottleneck_out = nn.Linear(dim, flat)
        kernel, stride = (cfg.time_kernel, cfg.freq_kernel), (1, cfg.freq_stride)
        self.dec = nn.ModuleList(
            nn.ConvTranspose2d(features, 1 if index == 0 else cfg.channels[index - 1], kernel, stride=stride)
            for index, features in enumerate(cfg.channels)
        )
        self.dec_norm = nn.ModuleList(
            nn.Identity() if index == 0 else nn.GroupNorm(4, cfg.channels[index - 1], eps=_NORM_EPS)
            for index in range(len(cfg.channels))
        )

    def forward(self, magnitude: torch.Tensor) -> torch.Tensor:
        # Per-sample scale normalization (population std): the mask is level-invariant.
        scale = torch.std(magnitude, dim=(1, 2), correction=0, keepdim=True) + _EPS
        x = (magnitude / scale)[:, None]  # (B, 1, T, F)
        skips = []
        for layer in self.enc:
            x = layer(x)
            skips.append(x)
        b, c, t, f = x.shape
        tokens = self.bottleneck_in(x.permute(0, 2, 3, 1).reshape(b, t, f * c))
        for layer in self.bottleneck:
            tokens = layer(tokens)
        x = x + self.bottleneck_out(tokens).reshape(b, t, f, c).permute(0, 3, 1, 2)
        for index in reversed(range(len(self.dec))):
            x = _same_transpose(self.dec[index], x + skips[index])
            if index > 0:
                x = _gelu(self.dec_norm[index](x))
        return torch.sigmoid(x[:, 0])


def _window(n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=like.real.dtype, device=like.device)


def _stft(segments: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex STFT of batched fixed-length segments (reflect-centred, Hann): (B, S) → (B, T, F)."""
    spec = torch.stft(
        segments, n_fft, hop, window=_window(n_fft, segments), center=True, pad_mode="reflect",
        return_complex=True,
    )
    return spec.transpose(1, 2)


def _istft(spectrum: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Weighted overlap-add inverse of :func:`_stft`: (B, T, F) → (B, S)."""
    return torch.istft(spectrum.transpose(1, 2), n_fft, hop, window=_window(n_fft, spectrum), center=True, length=length)


# --------------------------------------------------------------------------- #
# Parameters: the flax tree, its .npz, and the module built from it
# --------------------------------------------------------------------------- #


def _truncated_normal(rng: np.random.Generator, shape: tuple[int, ...], fan_in: int) -> np.ndarray:
    """flax's default kernel init (LeCun normal, truncated at two deviations), drawn in numpy."""
    values = rng.standard_normal(shape)
    outside = np.abs(values) > 2.0
    while outside.any():
        values[outside] = rng.standard_normal(int(outside.sum()))
        outside = np.abs(values) > 2.0
    # 0.8796...: the standard deviation of a unit normal truncated to [-2, 2].
    return (values * math.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)


def init_separator_params(config: SeparatorConfig, *, seed: int = 0) -> dict:
    """A random flax-layout parameter tree (float32 numpy), keyed as the flax module's.

    The distributions are flax's defaults; the draws come from
    ``np.random.default_rng(seed)``, not ``jax.random``.
    """
    cfg = config
    rng = np.random.default_rng(seed)

    def kernel(shape: tuple[int, ...], fan_in: int) -> dict:
        return {"kernel": _truncated_normal(rng, shape, fan_in), "bias": np.zeros(shape[-1], np.float32)}

    def norm(features: int) -> dict:
        return {"scale": np.ones(features, np.float32), "bias": np.zeros(features, np.float32)}

    kt, kf = cfg.time_kernel, cfg.freq_kernel
    params: dict = {}
    for index, (cin, features) in enumerate(zip((1, *cfg.channels[:-1]), cfg.channels)):
        params[f"enc{index}"] = {"conv": kernel((kt, kf, cin, 2 * features), kt * kf * cin), "norm": norm(2 * features)}
    dim = cfg.channels[-1]
    flat = cfg.bottom_freq * dim
    heads, head_dim = cfg.bottleneck_heads, dim // cfg.bottleneck_heads
    params["bottleneck_in"] = kernel((flat, dim), flat)
    for index in range(cfg.bottleneck_layers):
        attn = {name: kernel((dim, heads, head_dim), dim) for name in ("query", "key", "value")}
        for name in ("query", "key", "value"):
            attn[name]["bias"] = np.zeros((heads, head_dim), np.float32)
        attn["out"] = kernel((heads, head_dim, dim), dim)
        params[f"bottleneck{index}"] = {
            "attn_norm": norm(dim),
            "attn": attn,
            "ffn_norm": norm(dim),
            "ffn_up": kernel((dim, 4 * dim), dim),
            "ffn_down": kernel((4 * dim, dim), 4 * dim),
        }
    params["bottleneck_out"] = kernel((dim, flat), dim)
    for index, features in enumerate(cfg.channels):
        out = 1 if index == 0 else cfg.channels[index - 1]
        params[f"dec{index}"] = kernel((kt, kf, features, out), kt * kf * features)
        if index > 0:
            params[f"dec{index}_norm"] = norm(out)
    return params


def build_separator(params: dict, config: SeparatorConfig, *, device: torch.device | str) -> SpecUNetSeparator:
    """The module with a flax-layout tree's weights, on ``device``, in eval mode."""
    from ser_tpu_torch.models.convert import separator_state_dict

    model = SpecUNetSeparator(config)
    model.load_state_dict(separator_state_dict(params, config))
    return model.to(device).eval()


def _flatten(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


_CONFIG_KEY = "__separator_config__"


def save_separator_params(params: dict, path, *, config: SeparatorConfig | None = None) -> None:
    """Writes a flax-layout tree as a flat ``.npz`` (no pickle), with the config record when given."""
    flat = _flatten(params)
    if config is not None:
        record = dataclasses.asdict(config)
        record["channels"] = list(record["channels"])
        flat[_CONFIG_KEY] = np.frombuffer(json.dumps(record).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def load_separator_params(path) -> tuple[dict, SeparatorConfig | None]:
    """Reads a flat ``.npz``: (flax-layout tree of numpy arrays, bundled config or None)."""
    params: dict = {}
    config: SeparatorConfig | None = None
    with np.load(path) as archive:
        for flat_key in archive.files:
            if flat_key == _CONFIG_KEY:
                record = json.loads(bytes(archive[flat_key]).decode("utf-8"))
                record["channels"] = tuple(record["channels"])
                config = SeparatorConfig(**record)
                continue
            node = params
            *parents, leaf = [part for part in flat_key.split("/") if part]
            for parent in parents:
                node = node.setdefault(parent, {})
            node[leaf] = archive[flat_key]
    return params, config


# --------------------------------------------------------------------------- #
# Separation and its training objective
# --------------------------------------------------------------------------- #


def separate_segments(model: SpecUNetSeparator, segments: torch.Tensor) -> torch.Tensor:
    """Masks one batch of fixed-length segments: (B, S) → vocal (B, S)."""
    config = model.config
    spec = _stft(segments, config.n_fft, config.hop)[..., : config.freq_bins]
    vocal = spec * model(spec.abs()).to(spec.dtype)
    # Restore the dropped Nyquist bin as zero for the inverse transform.
    return _istft(F.pad(vocal, (0, 1)), config.n_fft, config.hop, segments.shape[1])


def separate_vocals_neural(audio: np.ndarray, sample_rate: int, *, model: SpecUNetSeparator) -> np.ndarray:
    """Full-file separation on the model's device: overlapping segments, one call, blended.

    The file is cut into ``segment_seconds`` windows at ``overlap``
    fractional overlap, every window is masked in one batched call, and the
    windows are blended with linear ramps so segment boundaries are seamless.
    """
    config = model.config
    if sample_rate != config.sample_rate:
        raise ValueError(f"Separator expects {config.sample_rate} Hz audio, got {sample_rate}.")
    audio = np.asarray(audio, dtype=np.float32)
    length = audio.size
    segment = config.segment_samples
    if length == 0:
        return audio
    stride = max(1, int(segment * (1.0 - config.overlap)))
    starts = list(range(0, max(length - segment, 0) + 1, stride))
    if not starts or starts[-1] + segment < length:
        starts.append(max(0, length - segment))
    padded = np.pad(audio, (0, max(0, starts[-1] + segment - length)))
    device = next(model.parameters()).device
    batch = torch.from_numpy(np.stack([padded[s : s + segment] for s in starts])).to(device)
    with torch.inference_mode(), strict_float32(device):
        vocal_segments = separate_segments(model, batch).cpu().numpy()

    ramp = min(segment - 1, max(1, segment - stride))
    weight = np.ones(segment)
    weight[:ramp] = np.linspace(1.0 / ramp, 1.0, ramp)
    weight[-ramp:] = np.linspace(1.0, 1.0 / ramp, ramp)
    output = np.zeros(padded.size)
    norm = np.zeros(padded.size)
    for row, start in enumerate(starts):
        output[start : start + segment] += vocal_segments[row] * weight
        norm[start : start + segment] += weight
    return (output / np.maximum(norm, _EPS))[:length].astype(np.float32)


def separation_loss(model: SpecUNetSeparator, mixture_segments: torch.Tensor, vocal_targets: torch.Tensor) -> torch.Tensor:
    """L1 spectral + L1 time-domain training objective (demucs's loss family)."""
    config = model.config
    estimate = separate_segments(model, mixture_segments)
    time_l1 = torch.mean(torch.abs(estimate - vocal_targets))
    est_spec = _stft(estimate, config.n_fft, config.hop).abs()
    ref_spec = _stft(vocal_targets, config.n_fft, config.hop).abs()
    return time_l1 + torch.mean(torch.abs(est_spec - ref_spec))


__all__ = [
    "SeparatorConfig",
    "SpecUNetSeparator",
    "build_separator",
    "init_separator_params",
    "load_separator_params",
    "save_separator_params",
    "separate_segments",
    "separate_vocals_neural",
    "separation_loss",
]
