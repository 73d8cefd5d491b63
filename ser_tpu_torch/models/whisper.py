"""Whisper encoder in PyTorch: the accurate profile's embedding model.

Counterpart of the encoder half of ``ser_tpu/models/whisper.py``:

- the log-mel frontend (``log_mel_spectrogram``): the STFT, kernel K1
  (power → mel → log10) and Whisper's normalization;
- the pre-norm encoder (conv ×2 stride-2 stem with exact GELU, sinusoidal
  positions, ``EncoderBlock`` × n, final LayerNorm) as ``nn.Module``s whose
  self-attention runs kernel K2 on the card;
- the HF checkpoint loader (``load_hf_whisper_encoder_params``), which returns
  the same parameter tree of numpy arrays as the JAX loader and keeps its
  consumed-key audit, plus a seeded ``torch.Generator`` random init.

The dtype policy is the JAX package's: matmuls and convolutions in the
compute dtype (bf16 on the card, float32 on the CPU), LayerNorms computed in
float32 with flax's fast variance E[x²]−E[x]², block LayerNorm outputs in
``ln_dtype`` (float32), the residual stream in the compute dtype after
``conv2``, the final LayerNorm in the compute dtype and cast to float32, and
every float parameter stored in the compute dtype (LayerNorm affines too).

Layouts: flax Conv kernels (k, in, out) are ``nn.Conv1d`` weights (out, in, k);
flax Dense kernels (in, out) are ``nn.Linear`` weights (out, in); ``k`` has no
bias. ``convert.py`` carries a JAX parameter tree across.
"""

from __future__ import annotations

import json
import logging
import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ser_tpu_torch.models.attention import multi_head_attention
from ser_tpu_torch.models.checkpoint_audit import AuditedState, unconsumed_key_error
from ser_tpu_torch.ops.activations import gelu_erf
from ser_tpu_torch.ops.log_mel import log_mel_raw, normalize_log_mel, set_strict_float32

logger = logging.getLogger(__name__)

N_FFT = 400
HOP_LENGTH = 160
SAMPLE_RATE = 16000
CHUNK_SECONDS = 30
CHUNK_SAMPLES = CHUNK_SECONDS * SAMPLE_RATE
CHUNK_FRAMES = CHUNK_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30 s window


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper architecture hyperparameters (defaults = large-v3)."""

    n_mels: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    n_heads: int = 20
    vocab_size: int = 51866
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls(
            n_mels=80,
            d_model=64,
            encoder_layers=2,
            decoder_layers=2,
            n_heads=4,
            vocab_size=256,
            max_target_positions=64,
        )


# --------------------------------------------------------------------------- #
# Log-mel frontend
# --------------------------------------------------------------------------- #


def log_mel_spectrogram(waveform: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's log-mel features. (B, CHUNK_SAMPLES) → (B, CHUNK_FRAMES, n_mels).

    Hann window, 400-FFT/160-hop power, Slaney mel, log10 clamp at 1e-10
    (kernel K1 on the card), dynamic-range floor at max-8, then (x+4)/4.
    """
    raw = log_mel_raw(
        waveform,
        sr=SAMPLE_RATE,
        n_fft=N_FFT,
        hop_length=HOP_LENGTH,
        n_mels=n_mels,
        n_frames_out=CHUNK_FRAMES,
    )
    return normalize_log_mel(raw)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position table (sin | cos concatenation)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# --------------------------------------------------------------------------- #
# Encoder modules
# --------------------------------------------------------------------------- #


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics: float32 statistics with the fast variance.

    ``out_dtype`` None returns the input's dtype.
    """

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        mean_sq = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(torch.float32)
        y = (x32 - mean) * mul + self.bias.to(torch.float32)
        return y.to(self.out_dtype if self.out_dtype is not None else x.dtype)


class MultiHeadAttention(nn.Module):
    """Encoder self-attention: q/k/v projections, kernel K2, out projection."""

    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.n_heads = config.n_heads
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, d = x.shape
        x = x.to(self.q.weight.dtype)
        heads = (batch, seq, self.n_heads, d // self.n_heads)
        q = self.q(x).view(heads)
        k = self.k(x).view(heads)
        v = self.v(x).view(heads)
        out = multi_head_attention(q, k, v, compute_dtype=x.dtype)
        return self.out(out.reshape(batch, seq, d))


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, config: WhisperConfig, ln_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d = config.d_model
        self.attn_ln = LayerNorm(d, config.layer_norm_eps, ln_dtype)
        self.attn = MultiHeadAttention(config)
        self.mlp_ln = LayerNorm(d, config.layer_norm_eps, ln_dtype)
        self.mlp_in = nn.Linear(d, 4 * d)
        self.mlp_out = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        h = self.mlp_ln(x).to(self.mlp_in.weight.dtype)
        return x + self.mlp_out(gelu_erf(self.mlp_in(h)))


class WhisperEncoder(nn.Module):
    """Mel frames → contextual states. (B, CHUNK_FRAMES, n_mels) → (B, T/2, d) float32."""

    def __init__(self, config: WhisperConfig, ln_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d = config.d_model
        self.config = config
        self.conv1 = nn.Conv1d(config.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.layers = nn.ModuleList(EncoderBlock(config, ln_dtype) for _ in range(config.encoder_layers))
        self.final_ln = LayerNorm(d, config.layer_norm_eps)
        self._positions: dict[tuple, torch.Tensor] = {}

    def _position_table(self, length: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (length, device, dtype)
        if key not in self._positions:
            table = torch.from_numpy(_sinusoids(length, self.config.d_model))
            self._positions[key] = table.to(device=device, dtype=dtype)
        return self._positions[key]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        x = gelu_erf(self.conv1(mel.to(dtype).transpose(1, 2)))
        x = gelu_erf(self.conv2(x)).transpose(1, 2)
        x = x + self._position_table(x.shape[1], x.device, dtype)[None]
        for layer in self.layers:
            x = layer(x)
        return self.final_ln(x).to(torch.float32)


def build_whisper_encoder(
    config: WhisperConfig,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device,
    dtype: torch.dtype,
) -> WhisperEncoder:
    """An eval-mode encoder holding ``state_dict`` on ``device``, stored in ``dtype``.

    Built on the meta device and filled by assignment, so the full-size model
    never runs PyTorch's default init or holds a second copy.
    """
    with torch.device("meta"):
        encoder = WhisperEncoder(config)
    placed = {name: tensor.to(device=device, dtype=dtype) for name, tensor in state_dict.items()}
    encoder.load_state_dict(placed, strict=True, assign=True)
    return encoder.eval()


@torch.inference_mode()
def encode_mel_chunks(encoder: WhisperEncoder, chunks: torch.Tensor) -> torch.Tensor:
    """(B, CHUNK_SAMPLES) waveform chunks → (B, 1500, d) float32 encoder states."""
    if chunks.device.type == "cuda":
        set_strict_float32()
    mel = log_mel_spectrogram(chunks, encoder.config.n_mels)
    return encoder(mel)


# --------------------------------------------------------------------------- #
# Random init + HF conversion
# --------------------------------------------------------------------------- #


def random_whisper_encoder_state(
    config: WhisperConfig, *, seed: int, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Seeded random float32 weights, drawn by a ``torch.Generator`` on ``device``.

    flax's default init shapes: truncated-normal kernels with std 1/√fan_in,
    zero biases, unit LayerNorm scales. The values differ from
    ``ser_tpu.models.whisper.init_whisper_encoder_params`` for the same seed;
    tests carry JAX's weights across with ``convert.py`` instead.
    """
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shapes = {name: tensor.shape for name, tensor in WhisperEncoder(config).state_dict().items()}
    state: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            state[name] = torch.zeros(shape, device=device)
        elif "_ln." in name:
            state[name] = torch.ones(shape, device=device)
        else:
            fan_in = math.prod(shape[1:])
            std = 1.0 / math.sqrt(fan_in)
            tensor = torch.empty(shape, device=device)
            nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
            state[name] = tensor
    return state


def whisper_config_from_hf_dir(model_dir) -> WhisperConfig:
    raw = json.loads((Path(model_dir) / "config.json").read_text(encoding="utf-8"))
    return WhisperConfig(
        n_mels=raw.get("num_mel_bins", 80),
        d_model=raw["d_model"],
        encoder_layers=raw["encoder_layers"],
        decoder_layers=raw["decoder_layers"],
        n_heads=raw["encoder_attention_heads"],
        vocab_size=raw["vocab_size"],
        max_target_positions=raw.get("max_target_positions", 448),
    )


_SAFETENSORS_DTYPES = {
    "F64": "<f8",
    "F32": "<f4",
    "F16": "<f2",
    "I64": "<i8",
    "I32": "<i4",
    "I16": "<i2",
    "I8": "i1",
    "U8": "u1",
    "BOOL": "?",
}


def _read_safetensors(path: Path) -> dict[str, np.ndarray]:
    """A ``*.safetensors`` file as numpy arrays (bf16 widened to float32).

    The format: an 8-byte little-endian header length, a JSON header mapping
    each name to its dtype, shape and byte range, then the raw tensors.
    """
    with path.open("rb") as handle:
        (header_len,) = struct.unpack("<Q", handle.read(8))
        header = json.loads(handle.read(header_len))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
    tensors: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            flat = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            flat = raw.view(_SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"Unsupported safetensors dtype {info['dtype']!r} for {name!r} in {path}.")
        tensors[name] = np.array(flat.reshape(info["shape"]))
    return tensors


def _hf_tensors(model_dir) -> dict[str, np.ndarray]:
    """A local HF checkpoint's tensors as numpy (safetensors or ``pytorch_model*.bin``)."""
    model_dir = Path(model_dir)
    safetensor_files = sorted(model_dir.glob("*.safetensors"))
    merged: dict[str, np.ndarray] = {}
    if safetensor_files:
        for file in safetensor_files:
            merged.update(_read_safetensors(file))
        return merged
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(f"No model weights (*.safetensors / *.bin) in {model_dir}.")
    for file in bin_files:
        state = torch.load(str(file), map_location="cpu", weights_only=True)
        merged.update(
            {
                key: (value.float() if value.dtype == torch.bfloat16 else value).numpy()
                for key, value in state.items()
            }
        )
    return merged


def _attention_params(t, base_hf: str) -> dict:
    return {
        "q": {"kernel": t(f"{base_hf}.q_proj.weight").T, "bias": t(f"{base_hf}.q_proj.bias")},
        "k": {"kernel": t(f"{base_hf}.k_proj.weight").T},
        "v": {"kernel": t(f"{base_hf}.v_proj.weight").T, "bias": t(f"{base_hf}.v_proj.bias")},
        "out": {"kernel": t(f"{base_hf}.out_proj.weight").T, "bias": t(f"{base_hf}.out_proj.bias")},
    }


def load_hf_whisper_encoder_params(model_dir, config: WhisperConfig) -> dict:
    """A local HF Whisper checkpoint's encoder weights as the JAX parameter tree.

    Same tree of numpy arrays as ``ser_tpu.models.whisper.
    load_hf_whisper_encoder_params``: missing weights raise by name, and
    encoder tensors the conversion never consumed refuse the load. The fixed
    sinusoidal position table is recomputed, not loaded.
    """
    sd = AuditedState(_hf_tensors(model_dir))

    def t(name):
        for key in (name, f"model.{name}"):
            if key in sd:
                return sd.take(key)
        raise KeyError(f"Missing weight {name!r}.")

    params: dict = {
        "conv1": {
            "kernel": t("encoder.conv1.weight").transpose(2, 1, 0),
            "bias": t("encoder.conv1.bias"),
        },
        "conv2": {
            "kernel": t("encoder.conv2.weight").transpose(2, 1, 0),
            "bias": t("encoder.conv2.bias"),
        },
        "final_ln": {
            "scale": t("encoder.layer_norm.weight"),
            "bias": t("encoder.layer_norm.bias"),
        },
    }
    for i in range(config.encoder_layers):
        base = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "attn_ln": {
                "scale": t(f"{base}.self_attn_layer_norm.weight"),
                "bias": t(f"{base}.self_attn_layer_norm.bias"),
            },
            "attn": _attention_params(t, f"{base}.self_attn"),
            "mlp_ln": {
                "scale": t(f"{base}.final_layer_norm.weight"),
                "bias": t(f"{base}.final_layer_norm.bias"),
            },
            "mlp_in": {"kernel": t(f"{base}.fc1.weight").T, "bias": t(f"{base}.fc1.bias")},
            "mlp_out": {"kernel": t(f"{base}.fc2.weight").T, "bias": t(f"{base}.fc2.bias")},
        }

    leftovers = sd.unconsumed(
        scope_prefixes=("encoder.", "model.encoder."),
        ignore_exact=(
            "encoder.embed_positions.weight",
            "model.encoder.embed_positions.weight",
        ),
    )
    if leftovers:
        raise unconsumed_key_error(leftovers, model="whisper encoder")
    return params


__all__ = [
    "CHUNK_FRAMES",
    "CHUNK_SAMPLES",
    "CHUNK_SECONDS",
    "EncoderBlock",
    "HOP_LENGTH",
    "LayerNorm",
    "MultiHeadAttention",
    "N_FFT",
    "SAMPLE_RATE",
    "WhisperConfig",
    "WhisperEncoder",
    "build_whisper_encoder",
    "encode_mel_chunks",
    "load_hf_whisper_encoder_params",
    "log_mel_spectrogram",
    "random_whisper_encoder_state",
    "whisper_config_from_hf_dir",
]
