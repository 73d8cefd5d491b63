"""Plain reference of the Whisper encoder's path: log-mel, the encoder, its frame times.

Follows the published model (OpenAI's ``whisper/audio.py`` and ``model.py``): a periodic
Hann window, 400-point STFT at hop 160 with reflect padding, power, Slaney mel
filterbank, log10 clamped at 1e-10, a floor 8 below each window's maximum, then
(x + 4) / 4; two GELU convolutions (the second of stride 2), sinusoidal positions,
pre-norm blocks of self-attention and a 4·d GELU MLP, and a final LayerNorm. The front
end runs in float64, the encoder's sums in float32 with TF32 off, in blocks of windows;
with the configuration's ``reference: {"activations": "bfloat16"}`` the values it serves
in bf16 are rounded to bf16 where it states them (``encode``).

The weights are those the port draws in its seeded random init (``SER_ALLOW_RANDOM_INIT``):
a ``torch.Generator`` on the device, seeded by the first four bytes of the SHA-256 of
``"<backend id>:<model id>"``, drawing a truncated normal (std 1/sqrt(fan in), cut at 2
std) for each weight matrix in the order below, zero biases and unit LayerNorm scales.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, WINDOW_SAMPLES, MEL_FRAMES = 400, 160, 480000, 3000


def init_seed(backend_id: str, model_id: str) -> int:
    """The seed of the port's random init for one (backend, model) pair."""
    return int.from_bytes(hashlib.sha256(f"{backend_id}:{model_id}".encode()).digest()[:4], "big")


def parameter_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The encoder's tensors in the order the port's init draws them."""
    d, mels, ffn = cfg["d_model"], cfg["num_mel_bins"], cfg["encoder_ffn_dim"]
    shapes = [("conv1.weight", (d, mels, 3)), ("conv1.bias", (d,)), ("conv2.weight", (d, d, 3)), ("conv2.bias", (d,))]
    for i in range(cfg["encoder_layers"]):
        p = f"layers.{i}."
        shapes += [
            (p + "attn_ln.weight", (d,)), (p + "attn_ln.bias", (d,)),
            (p + "attn.q.weight", (d, d)), (p + "attn.q.bias", (d,)),
            (p + "attn.k.weight", (d, d)),
            (p + "attn.v.weight", (d, d)), (p + "attn.v.bias", (d,)),
            (p + "attn.out.weight", (d, d)), (p + "attn.out.bias", (d,)),
            (p + "mlp_ln.weight", (d,)), (p + "mlp_ln.bias", (d,)),
            (p + "mlp_in.weight", (ffn, d)), (p + "mlp_in.bias", (ffn,)),
            (p + "mlp_out.weight", (d, ffn)), (p + "mlp_out.bias", (d,)),
        ]
    return shapes + [("final_ln.weight", (d,)), ("final_ln.bias", (d,))]


def draw_weights(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """float32 weights as the port's seeded init draws them on ``device``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    weights = {}
    for name, shape in parameter_shapes(cfg):
        if name.endswith("bias"):
            weights[name] = torch.zeros(shape, device=device)
        elif "_ln." in name:
            weights[name] = torch.ones(shape, device=device)
        else:
            std = 1.0 / math.sqrt(math.prod(shape[1:]))
            tensor = torch.empty(shape, device=device)
            torch.nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
            weights[name] = tensor
    return weights


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    linear = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), linear)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * (200.0 / 3))


def mel_filterbank(n_mels: int, sr: int = 16000, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney mel filterbank with area normalization, (n_mels, n_fft // 2 + 1), float64."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    lower = (freqs[None, :] - edges[:-2, None]) / (edges[1:-1] - edges[:-2])[:, None]
    upper = (edges[2:, None] - freqs[None, :]) / (edges[2:] - edges[1:-1])[:, None]
    return np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def log_mel(windows: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) float64 samples → (B, 3000, n_mels) normalized log-mel, float64."""
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(N_FFT, dtype=torch.float64, device=windows.device) / N_FFT)
    padded = F.pad(windows[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP)[:, :MEL_FRAMES]
    power = torch.fft.rfft(frames * hann, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(windows.device)
    logs = torch.log10(torch.clamp(power @ fb.T, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def _sinusoids(length: int, channels: int, device: torch.device) -> torch.Tensor:
    inv = torch.exp(-math.log(10000.0) / (channels // 2 - 1) * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).to(device=device, dtype=torch.float32)


def _as_bf16(t: torch.Tensor) -> torch.Tensor:
    """The nearest bf16 value of each element, held in float32."""
    return t.to(torch.bfloat16).float()


def encode(mel: torch.Tensor, w: dict[str, torch.Tensor], cfg: dict, served: bool = False,
           product=F.linear) -> torch.Tensor:
    """(B, 3000, n_mels) log-mel → (B, 1500, d) float32 states.

    ``served``: the values as the configuration serves them (``reference: activations
    bfloat16``): every product's inputs and output, the convolutions' outputs and the
    residual stream rounded to bf16, LayerNorm statistics and every sum in float32.
    ``product(x, weight, bias)`` computes the layers' projections (a lower-precision one
    makes the control).
    """
    r = _as_bf16 if served else (lambda t: t)
    d, heads, eps = cfg["d_model"], cfg["encoder_attention_heads"], cfg["layer_norm_eps"]
    x = r(F.gelu(r(F.conv1d(r(mel.float()).transpose(1, 2), w["conv1.weight"], w["conv1.bias"], padding=1))))
    x = r(F.gelu(r(F.conv1d(x, w["conv2.weight"], w["conv2.bias"], stride=2, padding=1)))).transpose(1, 2)
    x = r(x + r(_sinusoids(x.shape[1], d, x.device)))
    batch, seq, _ = x.shape
    for i in range(cfg["encoder_layers"]):
        p = f"layers.{i}."
        h = r(F.layer_norm(x, (d,), w[p + "attn_ln.weight"], w[p + "attn_ln.bias"], eps))
        q = r(product(h, w[p + "attn.q.weight"], w[p + "attn.q.bias"])).view(batch, seq, heads, -1).transpose(1, 2)
        k = r(product(h, w[p + "attn.k.weight"], None)).view(batch, seq, heads, -1).transpose(1, 2)
        v = r(product(h, w[p + "attn.v.weight"], w[p + "attn.v.bias"])).view(batch, seq, heads, -1).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        attended = r((torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(batch, seq, d))
        x = r(x + r(product(attended, w[p + "attn.out.weight"], w[p + "attn.out.bias"])))
        h = r(F.layer_norm(x, (d,), w[p + "mlp_ln.weight"], w[p + "mlp_ln.bias"], eps))
        h = r(F.gelu(r(product(h, w[p + "mlp_in.weight"], w[p + "mlp_in.bias"]))))
        x = r(x + r(product(h, w[p + "mlp_out.weight"], w[p + "mlp_out.bias"])))
    return r(F.layer_norm(x, (d,), w["final_ln.weight"], w["final_ln.bias"], eps))


def frame_states(audio16k: np.ndarray, w: dict[str, torch.Tensor], cfg: dict, device: torch.device,
                 product=F.linear, block: int = 2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(states (N, d) float32, frame starts, frame ends) of a clip at 16 kHz (``frame_times``)."""
    n_windows = max(1, math.ceil(audio16k.size / WINDOW_SAMPLES))
    padded = np.zeros(n_windows * WINDOW_SAMPLES)
    padded[: audio16k.size] = audio16k
    rows = torch.from_numpy(padded.reshape(n_windows, WINDOW_SAMPLES)).to(device)
    with torch.no_grad():
        served = cfg.get("reference", {}).get("activations") == "bfloat16"
        states = torch.cat([encode(log_mel(rows[i : i + block], cfg["num_mel_bins"]), w, cfg, served, product).cpu()
                            for i in range(0, n_windows, block)]).numpy()
    counts = valid_counts(audio16k.size, states.shape[1])
    starts, ends = frame_times(audio16k.size, states.shape[1])
    return np.concatenate([states[row, :n] for row, n in enumerate(counts)]), starts, ends


def valid_counts(samples16k: int, states: int = 1500) -> list[int]:
    """Frames each 30 s window keeps: round(states·s / 30) for a window of s seconds."""
    windows = max(1, math.ceil(samples16k / WINDOW_SAMPLES))
    return [max(1, int(round(states * min(WINDOW_SAMPLES, samples16k - row * WINDOW_SAMPLES) / 16000 / 30)))
            for row in range(windows)]


def frame_times(samples16k: int, states: int = 1500) -> tuple[np.ndarray, np.ndarray]:
    """Start and end seconds of a clip's frames: each window's kept frames cover its true
    duration evenly."""
    starts, ends = [], []
    for row, n_valid in enumerate(valid_counts(samples16k, states)):
        duration = min(WINDOW_SAMPLES, samples16k - row * WINDOW_SAMPLES) / 16000
        step = duration / n_valid
        first = row * 30.0 + step * np.arange(n_valid)
        starts.append(first)
        ends.append(first + step)
    return np.concatenate(starts), np.concatenate(ends)
