"""Hybrid Transformer Demucs (demucs v4) in PyTorch: the real-weight separation lane.

Counterpart of ``ser_tpu/models/demucs_v4.py``. The transcript's
``use_demucs`` lane runs the published ``htdemucs`` model over the input
before transcription: dual spectrogram/waveform U-Nets with GLU-gated
convolutions and dilated-conv residual branches, a cross-domain transformer
bottleneck, and a complex-as-channels spectrogram output. This module holds
that forward, the converter from the published torch checkpoint
(``{"klass", "kwargs", "state"}`` or a raw ``state_dict``) into the
self-describing ``.npz`` both packages stage, and the 16 kHz mono entry point.

The forward is functional over the same nested parameter tree as the JAX
package's (``convert_demucs_state_dict``), with the tensors on one device.
Weights keep the published torch layouts (OIW/OIHW, transposed-conv weights
(in, out, k)), so the convolutions are PyTorch's own, the transposed ones
included; ``_spec``/``_ispec`` are ``torch.stft``/``torch.istft`` with the
published framing. Attention is what the JAX package computes outside any
kernel: two float32 products and a softmax (no TPU kernel lies on this path,
so none is ported here). On the card every float32 product and convolution
stays float32: TF32 is off for the forward (``strict_float32``).

Each dispatch runs only its real segments: the JAX package pads the last
dispatch with zero rows to a power of two so that ``jit`` compiles few
shapes; every normalization here is per row, so dropping those rows changes
no result (``ROADMAP.md``, Queue 3).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ser_tpu_torch.ops.activations import gelu_erf as _gelu

_EPS = 1e-5


@dataclass(frozen=True)
class DemucsV4Config:
    """htdemucs architecture hyperparameters (defaults = published htdemucs).

    Field names follow the published constructor so ``kwargs`` recorded in a
    checkpoint can be cross-checked mechanically.
    """

    sources: tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    depth: int = 4
    nfft: int = 4096
    bottom_channels: int = 512
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    kernel_size: int = 8
    stride: int = 4
    dconv_depth: int = 2
    dconv_comp: int = 4
    freq_emb_scale: float = 0.2
    emb_scale: float = 10.0
    max_period: float = 10000.0
    sample_rate: int = 44100
    segment_seconds: float = 7.8
    overlap: float = 0.25

    @property
    def hop(self) -> int:
        return self.nfft // 4

    @property
    def freq_bins(self) -> int:
        return self.nfft // 2

    @property
    def segment_samples(self) -> int:
        return int(self.segment_seconds * self.sample_rate)

    def layer_channels(self, index: int) -> int:
        return self.channels * self.growth**index

    @classmethod
    def tiny(cls) -> "DemucsV4Config":
        """Test-size model: sub-second CPU forward, same wiring."""
        return cls(
            sources=("other", "vocals"),
            audio_channels=2,
            channels=4,
            depth=2,
            nfft=64,
            bottom_channels=16,
            t_layers=3,
            t_heads=2,
            sample_rate=44100,
            segment_seconds=0.02,
        )


@contextmanager
def strict_float32(device: torch.device) -> Iterator[None]:
    """Float32 matrix products and cuDNN convolutions in full float32 (no TF32) on the card."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --------------------------------------------------------------------------- #
# Encoder / decoder layers (published HEncLayer / HDecLayer / DConv)
# --------------------------------------------------------------------------- #


def _dconv(x: torch.Tensor, layers: list) -> torch.Tensor:
    """Dilated residual branch (published ``DConv``): (B, C, T).

    Each block: Conv1d(k=3, dilation 2**block) → GroupNorm(1) → GELU →
    Conv1d(1x1, 2C) → GroupNorm(1) → GLU → LayerScale; residual add.
    """
    for index, block in enumerate(layers):
        dilation = 2**index
        y = F.conv1d(x, block["conv1"]["weight"], block["conv1"]["bias"], padding=dilation, dilation=dilation)
        y = _gelu(F.group_norm(y, 1, block["norm1"]["weight"], block["norm1"]["bias"], eps=_EPS))
        y = F.conv1d(y, block["conv2"]["weight"], block["conv2"]["bias"])
        y = F.glu(F.group_norm(y, 1, block["norm2"]["weight"], block["norm2"]["bias"], eps=_EPS), dim=1)
        x = x + y * block["scale"][None, :, None]
    return x


def _henc_layer(x: torch.Tensor, p: dict, cfg: DemucsV4Config, *, freq: bool) -> torch.Tensor:
    """Published ``HEncLayer``: strided conv → GELU → DConv → 1x1 GLU rewrite.

    htdemucs (depth 4, norm_starts=4) uses Identity norms in every layer.
    """
    pad = cfg.kernel_size // 4
    if freq:
        y = F.conv2d(x, p["conv"]["weight"], p["conv"]["bias"], stride=(cfg.stride, 1), padding=(pad, 0))
    else:
        length = x.shape[-1]
        if length % cfg.stride != 0:
            x = F.pad(x, (0, cfg.stride - length % cfg.stride))
        y = F.conv1d(x, p["conv"]["weight"], p["conv"]["bias"], stride=cfg.stride, padding=pad)
    y = _gelu(y)
    if freq:
        b, c, fr, t = y.shape
        flat = _dconv(y.transpose(1, 2).reshape(b * fr, c, t), p["dconv"])
        y = flat.reshape(b, fr, c, t).transpose(1, 2)
        return F.glu(F.conv2d(y, p["rewrite"]["weight"], p["rewrite"]["bias"]), dim=1)
    y = _dconv(y, p["dconv"])
    return F.glu(F.conv1d(y, p["rewrite"]["weight"], p["rewrite"]["bias"]), dim=1)


def _hdec_layer(
    x: torch.Tensor, skip: torch.Tensor, p: dict, cfg: DemucsV4Config, *, freq: bool, last: bool, length: int
) -> torch.Tensor:
    """Published ``HDecLayer``: skip add → 3-ctx GLU rewrite → transposed conv → crop."""
    pad = cfg.kernel_size // 4
    x = x + skip
    if freq:
        y = F.glu(F.conv2d(x, p["rewrite"]["weight"], p["rewrite"]["bias"], padding=1), dim=1)
        z = F.conv_transpose2d(y, p["conv_tr"]["weight"], p["conv_tr"]["bias"], stride=(cfg.stride, 1))
        z = z[:, :, pad:-pad, :]
    else:
        y = F.glu(F.conv1d(x, p["rewrite"]["weight"], p["rewrite"]["bias"], padding=1), dim=1)
        z = F.conv_transpose1d(y, p["conv_tr"]["weight"], p["conv_tr"]["bias"], stride=cfg.stride)
        z = z[:, :, pad : pad + length]
    return z if last else _gelu(z)


# --------------------------------------------------------------------------- #
# Cross-domain transformer (published CrossTransformerEncoder)
# --------------------------------------------------------------------------- #


def _layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps=_EPS)


def _mha(q: torch.Tensor, kv: torch.Tensor, p: dict, *, heads: int) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` (batch_first, packed in_proj): (B, T, C).

    Two products and a softmax, in the tokens' dtype (float32 on the path).
    """
    d = q.shape[-1]
    w, b = p["in_proj_weight"], p["in_proj_bias"]
    head_dim = d // heads

    def split(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], t.shape[1], heads, head_dim).transpose(1, 2)

    qp = split(F.linear(q, w[:d], b[:d]))
    kp = split(F.linear(kv, w[d : 2 * d], b[d : 2 * d]))
    vp = split(F.linear(kv, w[2 * d :], b[2 * d :]))
    scores = torch.matmul(qp, kp.transpose(-1, -2)) / math.sqrt(head_dim)
    out = torch.matmul(torch.softmax(scores, dim=-1), vp)
    out = out.transpose(1, 2).reshape(q.shape[0], q.shape[1], d)
    return F.linear(out, p["out_proj"]["weight"], p["out_proj"]["bias"])


def _ff_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    hidden = _gelu(F.linear(x, p["linear1"]["weight"], p["linear1"]["bias"]))
    return F.linear(hidden, p["linear2"]["weight"], p["linear2"]["bias"])


def _channel_groupnorm_last(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``MyGroupNorm(1, C)`` on (B, T, C): joint (T, C) statistics, per-C affine."""
    return F.group_norm(x.transpose(1, 2), 1, p["weight"], p["bias"], eps=_EPS).transpose(1, 2)


def _self_layer(x: torch.Tensor, p: dict, *, heads: int) -> torch.Tensor:
    """``MyTransformerEncoderLayer`` (norm_first, layer-scaled)."""
    h = _layer_norm(x, p["norm1"])
    y = x + p["gamma_1"] * _mha(h, h, p["self_attn"], heads=heads)
    y = y + p["gamma_2"] * _ff_block(_layer_norm(y, p["norm2"]), p)
    return _channel_groupnorm_last(y, p["norm_out"]) if "norm_out" in p else y


def _cross_layer(q: torch.Tensor, kv: torch.Tensor, p: dict, *, heads: int) -> torch.Tensor:
    """``CrossTransformerEncoderLayer`` (norm_first, layer-scaled)."""
    k = _layer_norm(kv, p["norm2"])
    y = q + p["gamma_1"] * _mha(_layer_norm(q, p["norm1"]), k, p["cross_attn"], heads=heads)
    y = y + p["gamma_2"] * _ff_block(_layer_norm(y, p["norm3"]), p)
    return _channel_groupnorm_last(y, p["norm_out"]) if "norm_out" in p else y


@lru_cache(maxsize=16)
def _sin_embedding_1d(length: int, dim: int, max_period: float) -> np.ndarray:
    """Published ``create_sin_embedding``: cos | sin halves, (T, dim)."""
    pos = np.arange(length)[:, None]
    half = dim // 2
    adim = np.arange(half)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=1).astype(np.float32)


@lru_cache(maxsize=16)
def _sin_embedding_2d(dim: int, height: int, width: int, max_period: float) -> np.ndarray:
    """Published ``create_2d_sin_embedding``: (dim, H, W), interleaved halves."""
    if dim % 4 != 0:
        raise ValueError("2D sinusoidal embedding needs dim % 4 == 0.")
    pe = np.zeros((dim, height, width), dtype=np.float32)
    half = dim // 2
    div = np.exp(np.arange(0.0, half, 2) * -(np.log(max_period) / half))
    pos_w = np.arange(width)[:, None]
    pos_h = np.arange(height)[:, None]
    sin_w = np.sin(pos_w * div).T[:, None, :]  # (half/2, 1, W)
    cos_w = np.cos(pos_w * div).T[:, None, :]
    pe[0:half:2] = np.repeat(sin_w, height, axis=1)
    pe[1:half:2] = np.repeat(cos_w, height, axis=1)
    sin_h = np.sin(pos_h * div).T[:, :, None]  # (half/2, H, 1)
    cos_h = np.cos(pos_h * div).T[:, :, None]
    pe[half::2] = np.repeat(sin_h, width, axis=2)
    pe[half + 1 :: 2] = np.repeat(cos_h, width, axis=2)
    return pe


def _crosstransformer(
    x: torch.Tensor, xt: torch.Tensor, p: dict, cfg: DemucsV4Config
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, Fr, T) spectral + (B, C, T) temporal token streams.

    Published wiring (``classic_parity=1``): even layers are CROSS (each
    branch attends the other's pre-update tokens), odd layers are SELF.
    """
    b, c, fr, t1 = x.shape
    # (b, c, fr, t1) -> tokens ordered (t1, fr) as in the published rearrange.
    tokens = x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)
    pos2d = torch.from_numpy(_sin_embedding_2d(c, fr, t1, cfg.max_period).transpose(2, 1, 0).reshape(t1 * fr, c))
    tokens = _layer_norm(tokens, p["norm_in"]) + pos2d.to(tokens.device, tokens.dtype)[None]

    t2 = xt.shape[-1]
    pos1d = torch.from_numpy(_sin_embedding_1d(t2, c, cfg.max_period))
    tokens_t = _layer_norm(xt.transpose(1, 2), p["norm_in_t"]) + pos1d.to(xt.device, xt.dtype)[None]

    for index in range(cfg.t_layers):
        lp, lpt = p["layers"][index], p["layers_t"][index]
        if index % 2 == 1:
            tokens = _self_layer(tokens, lp, heads=cfg.t_heads)
            tokens_t = _self_layer(tokens_t, lpt, heads=cfg.t_heads)
        else:
            old = tokens
            tokens = _cross_layer(tokens, tokens_t, lp, heads=cfg.t_heads)
            tokens_t = _cross_layer(tokens_t, old, lpt, heads=cfg.t_heads)

    return tokens.reshape(b, t1, fr, c).permute(0, 3, 2, 1), tokens_t.transpose(1, 2)


# --------------------------------------------------------------------------- #
# Spectrogram path (published _spec / _ispec)
# --------------------------------------------------------------------------- #


def _window(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=like.real.dtype, device=like.device)


def _spec(mix: torch.Tensor, cfg: DemucsV4Config) -> torch.Tensor:
    """(B, C, L) → complex (B, C, freq_bins, le) per the published ``_spec``."""
    b, c, length = mix.shape
    hop = cfg.hop
    le = int(math.ceil(length / hop))
    pad = hop // 2 * 3
    flat = F.pad(mix.reshape(b * c, 1, length), (pad, pad + le * hop - length), mode="reflect")[:, 0]
    z = torch.stft(
        flat, cfg.nfft, hop, window=_window(cfg.nfft, flat), normalized=True, center=True,
        pad_mode="reflect", return_complex=True,
    )
    # Drop the Nyquist row and the two edge frames on each side.
    return z[:, : cfg.freq_bins, 2 : 2 + le].reshape(b, c, cfg.freq_bins, le)


def _ispec(z: torch.Tensor, cfg: DemucsV4Config, length: int) -> torch.Tensor:
    """Inverse of :func:`_spec`: complex (..., freq_bins, le) → (..., length)."""
    *lead, freqs, le = z.shape
    hop = cfg.hop
    z = F.pad(z.reshape(-1, freqs, le), (2, 2, 0, 1))
    # An inverse real FFT reads only the real part of the DC bin (numpy's and
    # XLA's irfft, cuFFT in float64, the CPU in float32), but cuFFT's float32
    # inverse reads its imaginary part too: the network's DC row has one, and
    # left there it moved the card's float32 vocals 1.4e-3 from float64.
    z[:, 0].imag.zero_()
    pad = hop // 2 * 3
    total = hop * int(math.ceil(length / hop)) + 2 * pad
    x = torch.istft(z, cfg.nfft, hop, window=_window(cfg.nfft, z), normalized=True, center=True, length=total)
    return x[:, pad : pad + length].reshape(*lead, length)


# --------------------------------------------------------------------------- #
# Full forward
# --------------------------------------------------------------------------- #


def demucs_forward(params: dict, mix: torch.Tensor, config: DemucsV4Config) -> torch.Tensor:
    """One segment batch through htdemucs: (B, C, L) → (B, sources, C, L).

    The published ``HTDemucs.forward`` (eval mode): cac spectrogram and std
    normalization, dual encoders with the frequency embedding after layer 0,
    bottom channel up/down-samplers around the cross-domain transformer, skip
    decoders, complex-as-channels output recombined with the waveform branch.
    ``params`` and ``mix`` share one device and one floating dtype.
    """
    cfg = config
    b, _, length = mix.shape
    n_sources = len(cfg.sources)

    z = _spec(mix, cfg)
    # cac: (B, C, F, T) complex → (B, 2C, F, T) channels [re, im] per channel.
    mag = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, 2 * cfg.audio_channels, cfg.freq_bins, -1)
    mean = mag.mean(dim=(1, 2, 3), keepdim=True)
    # torch's .std() is the unbiased estimator (ddof=1), as the published model uses it.
    std = mag.std(dim=(1, 2, 3), keepdim=True)
    x = (mag - mean) / (_EPS + std)

    meant = mix.mean(dim=(1, 2), keepdim=True)
    stdt = mix.std(dim=(1, 2), keepdim=True)
    xt = (mix - meant) / (_EPS + stdt)

    saved, saved_t, lengths_t = [], [], []
    for idx in range(cfg.depth):
        lengths_t.append(xt.shape[-1])
        xt = _henc_layer(xt, params["tencoder"][idx], cfg, freq=False)
        saved_t.append(xt)
        x = _henc_layer(x, params["encoder"][idx], cfg, freq=True)
        if idx == 0:
            emb = (params["freq_emb"]["weight"][: x.shape[2]] * cfg.emb_scale).t()
            x = x + cfg.freq_emb_scale * emb[None, :, :, None]
        saved.append(x)

    bb, cc, fr, t1 = x.shape
    up = params["channel_upsampler"]
    x = F.conv1d(x.reshape(bb, cc, fr * t1), up["weight"], up["bias"]).reshape(bb, -1, fr, t1)
    xt = F.conv1d(xt, params["channel_upsampler_t"]["weight"], params["channel_upsampler_t"]["bias"])

    x, xt = _crosstransformer(x, xt, params["crosstransformer"], cfg)

    down = params["channel_downsampler"]
    x = F.conv1d(x.reshape(bb, x.shape[1], fr * t1), down["weight"], down["bias"]).reshape(bb, -1, fr, t1)
    xt = F.conv1d(xt, params["channel_downsampler_t"]["weight"], params["channel_downsampler_t"]["bias"])

    for idx in range(cfg.depth):
        last = idx == cfg.depth - 1
        x = _hdec_layer(x, saved.pop(), params["decoder"][idx], cfg, freq=True, last=last, length=0)
        xt = _hdec_layer(xt, saved_t.pop(), params["tdecoder"][idx], cfg, freq=False, last=last,
                         length=lengths_t.pop())

    # Complex-as-channels output → per-source complex spectrograms.
    x = x.reshape(b, n_sources, 2 * cfg.audio_channels, cfg.freq_bins, -1)
    x = x * std[:, None] + mean[:, None]
    x = x.reshape(b, n_sources, cfg.audio_channels, 2, cfg.freq_bins, x.shape[-1])
    spec_out = _ispec(torch.complex(x[:, :, :, 0], x[:, :, :, 1]), cfg, length)

    xt = xt.reshape(b, n_sources, cfg.audio_channels, length)
    xt = xt * stdt[:, None] + meant[:, None]
    return spec_out + xt


def vocals_forward(params: dict, mix: torch.Tensor, config: DemucsV4Config, vocals_index: int) -> torch.Tensor:
    """Forward + stem select and downmix on the device: (B, C, T) → vocals (B, T).

    The lane consumes only the mono vocals stem, so only it leaves the device.
    """
    with torch.inference_mode(), strict_float32(mix.device):
        return demucs_forward(params, mix, config)[:, vocals_index].mean(dim=1)


# --------------------------------------------------------------------------- #
# Checkpoint conversion (published torch layout → nested tree → .npz)
# --------------------------------------------------------------------------- #


def _take(state, name: str) -> np.ndarray:
    if name not in state:
        raise KeyError(f"Missing demucs weight {name!r}.")
    return np.asarray(state.take(name), dtype=np.float32)


def _conv_entry(state, base: str) -> dict:
    # Every conv/linear/norm of the published layout carries a bias; a missing
    # one is a doctored or truncated checkpoint, not a variant.
    return {"weight": _take(state, f"{base}.weight"), "bias": _take(state, f"{base}.bias")}


def _dconv_entries(state, base: str, depth: int) -> list[dict]:
    # Published Sequential indices: 0=conv 1=norm 2=GELU 3=conv 4=norm 5=GLU
    # 6=LayerScale; the dilation (2**j) is implied by position.
    return [
        {
            "conv1": _conv_entry(state, f"{base}.layers.{j}.0"),
            "norm1": _conv_entry(state, f"{base}.layers.{j}.1"),
            "conv2": _conv_entry(state, f"{base}.layers.{j}.3"),
            "norm2": _conv_entry(state, f"{base}.layers.{j}.4"),
            "scale": _take(state, f"{base}.layers.{j}.6.scale"),
        }
        for j in range(depth)
    ]


def _transformer_layer_entry(state, base: str, *, cross: bool) -> dict:
    attn = "cross_attn" if cross else "self_attn"
    entry = {
        attn: {
            "in_proj_weight": _take(state, f"{base}.{attn}.in_proj_weight"),
            "in_proj_bias": _take(state, f"{base}.{attn}.in_proj_bias"),
            "out_proj": _conv_entry(state, f"{base}.{attn}.out_proj"),
        },
        "linear1": _conv_entry(state, f"{base}.linear1"),
        "linear2": _conv_entry(state, f"{base}.linear2"),
        "norm1": _conv_entry(state, f"{base}.norm1"),
        "norm2": _conv_entry(state, f"{base}.norm2"),
        "gamma_1": _take(state, f"{base}.gamma_1.scale"),
        "gamma_2": _take(state, f"{base}.gamma_2.scale"),
    }
    if cross:
        entry["norm3"] = _conv_entry(state, f"{base}.norm3")
    if f"{base}.norm_out.weight" in state:
        entry["norm_out"] = _conv_entry(state, f"{base}.norm_out")
    return entry


def convert_demucs_state_dict(state: dict, config: DemucsV4Config) -> dict:
    """Published htdemucs ``state_dict`` → the nested parameter tree (float32 numpy).

    Accepts numpy arrays or CPU tensors as values; raises ``KeyError`` naming
    the first missing weight. A variant whose extra submodules only add keys
    (dconv attention/LSTM branches, non-Identity norms) refuses the load
    instead of converting into a forward that omits those weights.
    """
    from ser_tpu_torch.models.checkpoint_audit import AuditedState, unconsumed_key_error

    state = AuditedState(
        {key: value.detach().float().numpy() if isinstance(value, torch.Tensor) else value
         for key, value in state.items()}
    )
    cfg = config
    params: dict = {
        "freq_emb": {"weight": _take(state, "freq_emb.embedding.weight")},
        "channel_upsampler": _conv_entry(state, "channel_upsampler"),
        "channel_downsampler": _conv_entry(state, "channel_downsampler"),
        "channel_upsampler_t": _conv_entry(state, "channel_upsampler_t"),
        "channel_downsampler_t": _conv_entry(state, "channel_downsampler_t"),
        "encoder": [],
        "tencoder": [],
        "decoder": [],
        "tdecoder": [],
    }
    for idx in range(cfg.depth):
        for branch in ("encoder", "tencoder"):
            base = f"{branch}.{idx}"
            params[branch].append(
                {
                    "conv": _conv_entry(state, f"{base}.conv"),
                    "rewrite": _conv_entry(state, f"{base}.rewrite"),
                    "dconv": _dconv_entries(state, f"{base}.dconv", cfg.dconv_depth),
                }
            )
        for branch in ("decoder", "tdecoder"):
            # Published decoders run deepest-first: decoder.0 consumes the
            # transformer output, decoder.{depth-1} emits the output heads.
            base = f"{branch}.{idx}"
            params[branch].append(
                {"rewrite": _conv_entry(state, f"{base}.rewrite"), "conv_tr": _conv_entry(state, f"{base}.conv_tr")}
            )
    transformer: dict = {
        "norm_in": _conv_entry(state, "crosstransformer.norm_in"),
        "norm_in_t": _conv_entry(state, "crosstransformer.norm_in_t"),
        "layers": [],
        "layers_t": [],
    }
    for index in range(cfg.t_layers):
        cross = index % 2 == 0
        for stream in ("layers", "layers_t"):
            transformer[stream].append(
                _transformer_layer_entry(state, f"crosstransformer.{stream}.{index}", cross=cross)
            )
    params["crosstransformer"] = transformer
    leftovers = state.unconsumed()
    if leftovers:
        raise unconsumed_key_error(leftovers, model="demucs v4")
    return params


#: Structural constructor kwargs whose values the forward hardcodes (the
#: published htdemucs values); a checkpoint recording another value would need
#: branches this port does not implement, so conversion refuses it.
_ASSUMED_STRUCTURAL_KWARGS: dict[str, tuple] = {
    "cac": (True,),
    "rewrite": (True,),
    "multi_freqs": ((), [], None),
    "norm_groups": (4,),
    "dconv_mode": (1,),
    "context": (1,),
    "context_enc": (0,),
    "channels_time": (None,),
    "wiener_iters": (0,),
    "end_iters": (0,),
    "wiener_residual": (False,),
    "t_gelu": (True,),
    "t_norm_first": (True,),
    "t_norm_out": (True,),
    "t_emb": ("sin",),
    "t_cross_first": (False,),
    "t_layer_scale": (True,),
    "t_sparse_self_attn": (False,),
    "t_sparse_cross_attn": (False,),
    "t_max_period": (10000.0, 10000),
    "t_weight_pos_embed": (1.0, 1),
    "time_stride": (2,),
}

#: Kwargs consumed by :func:`config_from_checkpoint_kwargs`.
_CONSUMED_KWARGS = frozenset(
    {
        "sources", "audio_channels", "channels", "growth", "depth", "nfft", "bottom_channels", "t_layers",
        "t_heads", "t_hidden_scale", "kernel_size", "stride", "dconv_depth", "dconv_comp", "freq_emb",
        "emb_scale", "samplerate", "segment",
    }
)

#: Training- and init-time kwargs with no effect on the trained forward pass.
_BENIGN_KWARGS = frozenset(
    {
        "rescale", "emb_smooth", "use_train_segment", "t_dropout", "t_weight_decay", "t_lr",
        "t_cape_mean_normalize", "t_cape_augment", "t_cape_glob_loc_scale", "t_sin_random_shift",
        "t_max_positions", "t_mask_type", "t_mask_random_seed", "t_sparse_attn_window", "t_global_window",
        "t_sparsity", "t_auto_sparsity", "multi_freqs_depth", "dconv_init", "norm_starts",
    }
)


def config_from_checkpoint_kwargs(kwargs: dict) -> DemucsV4Config:
    """Builds a config from a checkpoint's recorded constructor kwargs.

    Structural kwargs the forward hardcodes are cross-checked (a variant
    recording e.g. ``dconv_mode=3`` or ``cac=False`` raises); ``norm_starts``
    below ``depth`` raises (those layers would use GroupNorm, which the
    Identity-norm stack does not implement); unknown kwargs log a warning.
    """
    for name, accepted in _ASSUMED_STRUCTURAL_KWARGS.items():
        if name in kwargs and kwargs[name] not in accepted:
            raise ValueError(
                f"Checkpoint kwarg {name}={kwargs[name]!r} differs from the structure this port implements "
                f"(expected one of {accepted}); refusing to convert into a mismatched architecture."
            )
    depth = int(kwargs.get("depth", 4))
    norm_starts = int(kwargs.get("norm_starts", 4))
    if norm_starts < depth:
        raise ValueError(
            f"Checkpoint kwarg norm_starts={norm_starts} < depth={depth}: layers past norm_starts use "
            "GroupNorm, which this port's Identity-norm encoder/decoder stack does not implement."
        )
    unknown = sorted(
        name for name in kwargs
        if name not in _CONSUMED_KWARGS and name not in _BENIGN_KWARGS and name not in _ASSUMED_STRUCTURAL_KWARGS
    )
    if unknown:
        from ser_tpu_torch._internal.utils.logger import get_logger

        get_logger(__name__).warning(
            "Unrecognized demucs checkpoint kwargs %s ignored; verify the converted output against the "
            "source model.",
            ", ".join(unknown),
        )
    return DemucsV4Config(
        sources=tuple(kwargs.get("sources", DemucsV4Config.sources)),
        audio_channels=kwargs.get("audio_channels", 2),
        channels=kwargs.get("channels", 48),
        growth=int(kwargs.get("growth", 2)),
        depth=kwargs.get("depth", 4),
        nfft=kwargs.get("nfft", 4096),
        bottom_channels=kwargs.get("bottom_channels", 512),
        t_layers=kwargs.get("t_layers", 5),
        t_heads=kwargs.get("t_heads", 8),
        t_hidden_scale=kwargs.get("t_hidden_scale", 4.0),
        kernel_size=kwargs.get("kernel_size", 8),
        stride=kwargs.get("stride", 4),
        dconv_depth=kwargs.get("dconv_depth", 2),
        dconv_comp=kwargs.get("dconv_comp", 4),
        freq_emb_scale=kwargs.get("freq_emb", 0.2),
        emb_scale=kwargs.get("emb_scale", 10.0),
        sample_rate=kwargs.get("samplerate", 44100),
        segment_seconds=float(kwargs.get("segment", 7.8)),
    )


def load_torch_checkpoint(path) -> tuple[dict, DemucsV4Config]:
    """Reads a published ``.th`` file (or a raw state dict), as ``torch.load`` gives it.

    The released htdemucs artifact is ``torch.save({"klass", "kwargs",
    "state"})`` with half-precision tensors; its ``klass`` is a pickled class
    reference, so the file is unpickled in full (``weights_only=False``), as
    the JAX package reads it: load only checkpoints from a trusted source. A
    bare ``state_dict`` converts with the default config.
    """
    package = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(package, dict) and "state" in package:
        state = package["state"]
        config = config_from_checkpoint_kwargs(dict(package.get("kwargs") or {}))
    else:
        state, config = package, DemucsV4Config()
    return convert_demucs_state_dict(state, config), config


# --------------------------------------------------------------------------- #
# .npz staging (self-describing, no pickle; the JAX package's format)
# --------------------------------------------------------------------------- #

_CONFIG_KEY = "__demucs_v4_config__"


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, (dict, list)):
            flat.update(_flatten(value, path))
        elif isinstance(value, torch.Tensor):
            flat[path] = value.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(value)
    return flat


def save_demucs_npz(params: dict, path, *, config: DemucsV4Config) -> None:
    """Writes the tree (numpy arrays or tensors) and its config record as one ``.npz``."""
    flat = _flatten(params)
    record = dataclasses.asdict(config)
    record["sources"] = list(record["sources"])
    flat[_CONFIG_KEY] = np.frombuffer(json.dumps(record).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(key.isdigit() for key in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {key: _listify(value) for key, value in node.items()}


def load_demucs_npz(path) -> tuple[dict, DemucsV4Config]:
    """The tree (float32 numpy, on the host) and the config of a staged ``.npz``."""
    nested: dict = {}
    config: DemucsV4Config | None = None
    with np.load(path) as archive:
        for flat_key in archive.files:
            if flat_key == _CONFIG_KEY:
                record = json.loads(bytes(archive[flat_key]).decode("utf-8"))
                record["sources"] = tuple(record["sources"])
                config = DemucsV4Config(**record)
                continue
            node = nested
            *parents, leaf = [part for part in flat_key.split("/") if part]
            for parent in parents:
                node = node.setdefault(parent, {})
            node[leaf] = archive[flat_key]
    if config is None:
        raise ValueError(f"{path} carries no bundled demucs config record.")
    return _listify(nested), config


def is_demucs_npz(path) -> bool:
    """True when a staged ``.npz`` is a converted htdemucs checkpoint."""
    try:
        with np.load(path) as archive:
            return _CONFIG_KEY in archive.files
    except (OSError, ValueError):
        return False


def convert_demucs_checkpoint(source_path, target_path) -> DemucsV4Config:
    """One-call converter: published ``.th`` → staged ``.npz``."""
    params, config = load_torch_checkpoint(source_path)
    save_demucs_npz(params, target_path, config=config)
    return config


def init_demucs_params(config: DemucsV4Config, *, seed: int = 0) -> dict:
    """Random tree via the synthetic state dict (bit-equal to the JAX package's for one seed)."""
    from ser_tpu_torch.models._demucs_synthetic import synthetic_state_dict

    return convert_demucs_state_dict(synthetic_state_dict(config, seed=seed), config)


# --------------------------------------------------------------------------- #
# Vocal-separation entry point (16 kHz mono SER lane)
# --------------------------------------------------------------------------- #


def separate_vocals_demucs(
    audio: np.ndarray,
    sample_rate: int,
    *,
    params: dict,
    config: DemucsV4Config,
) -> np.ndarray:
    """Mono waveform → vocals stem at the input rate.

    The published inference recipe around one forward: resample to the
    model's rate on the host (scipy polyphase), mono → stereo, cut
    ``segment_seconds`` windows at ``overlap`` fractional overlap, run them
    in dispatches of at most ``SER_DEMUCS_MAX_DEVICE_ROWS`` (default 8) rows
    on the device, blend with the published triangular weight in float64,
    resample back. The forward runs where ``params`` lie: tensors on a
    device, or host numpy, placed for this call on the device
    ``SER_TORCH_DEVICE`` names (the card unless the CPU is asked for).
    """
    from math import gcd

    from scipy.signal import resample_poly

    from ser_tpu_torch.models.convert import demucs_params

    audio = np.asarray(audio, dtype=np.float32)
    if audio.size == 0:
        return audio
    cfg = config
    params = demucs_params(params)
    device = params["freq_emb"]["weight"].device
    if sample_rate != cfg.sample_rate:
        g = gcd(cfg.sample_rate, sample_rate)
        work = resample_poly(audio, cfg.sample_rate // g, sample_rate // g).astype(np.float32)
    else:
        work = audio
    length = work.size
    segment = cfg.segment_samples
    stride = max(1, int(segment * (1.0 - cfg.overlap)))
    starts = list(range(0, max(length - segment, 0) + 1, stride))
    if not starts or starts[-1] + segment < length:
        starts.append(max(0, length - segment))
    padded = np.pad(work, (0, max(0, starts[-1] + segment - length)))

    # Device memory stays flat in clip duration: an hour at 44.1 kHz is about
    # 600 overlapped segments, which one batched forward could not hold.
    max_rows = max(1, int(os.environ.get("SER_DEMUCS_MAX_DEVICE_ROWS", "8")))
    vocals_index = cfg.sources.index("vocals")
    # Published triangular transition weight.
    weight = np.concatenate(
        [np.arange(1, segment // 2 + 1), np.arange(segment - segment // 2, 0, -1)]
    ).astype(np.float32)
    weight = weight / weight.max()
    acc = np.zeros(padded.size, dtype=np.float64)
    norm = np.zeros(padded.size, dtype=np.float64)
    for chunk_base in range(0, len(starts), max_rows):
        chunk = starts[chunk_base : chunk_base + max_rows]
        batch = np.stack([padded[s : s + segment] for s in chunk])
        stereo = torch.from_numpy(np.repeat(batch[:, None, :], cfg.audio_channels, axis=1)).to(device)
        vocal = vocals_forward(params, stereo, cfg, vocals_index).cpu().numpy()
        for row, start in enumerate(chunk):
            acc[start : start + segment] += vocal[row] * weight
            norm[start : start + segment] += weight
    blended = (acc / np.maximum(norm, 1e-8))[:length].astype(np.float32)

    if sample_rate != cfg.sample_rate:
        g = gcd(cfg.sample_rate, sample_rate)
        blended = np.asarray(resample_poly(blended, sample_rate // g, cfg.sample_rate // g), dtype=np.float32)
        blended = blended[: audio.size]
        if blended.size < audio.size:
            blended = np.pad(blended, (0, audio.size - blended.size))
    return blended


__all__ = [
    "DemucsV4Config",
    "config_from_checkpoint_kwargs",
    "convert_demucs_checkpoint",
    "convert_demucs_state_dict",
    "demucs_forward",
    "init_demucs_params",
    "is_demucs_npz",
    "load_demucs_npz",
    "load_torch_checkpoint",
    "save_demucs_npz",
    "separate_vocals_demucs",
    "strict_float32",
    "vocals_forward",
]
